"""Transport (flow matching), port of `dimsum_tpu/transport/transport.py`:
the time interval, the training draws and losses of the velocity, noise and
score models, the probability-flow drifts and scores, and the `Sampler`:
ODE sampling (dopri5, Euler, Heun; reversed), SDE sampling (Euler-Maruyama,
Heun, with the Mean, Tweedie, Euler or no last step) and the ODE
likelihood (a Hutchinson trace estimate).

Draws come from an explicit `torch.Generator`; where the JAX package takes
a PRNG key, the port takes a generator and, for the tests, a seam that
injects the draws (`draw` for the SDE noise, `eps` for the likelihood's
probe vectors).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Dict, Optional

import torch

from dimsum_torch.transport import path as path_mod
from dimsum_torch.transport.integrators import (_grid, _tvec, ode_dopri5,
                                                ode_euler, ode_heun,
                                                sde_euler_maruyama, sde_heun)
from dimsum_torch.transport.path import expand_t_like_x


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


class WeightType(enum.Enum):
    NONE = enum.auto()
    VELOCITY = enum.auto()
    LIKELIHOOD = enum.auto()


def mean_flat(x):
    """Mean over every axis but the first."""
    return x.mean(dim=tuple(range(1, x.ndim)))


@dataclasses.dataclass(frozen=True)
class Transport:
    model_type: ModelType
    path_type: PathType
    loss_type: WeightType
    train_eps: float
    sample_eps: float
    path_sampler: Any = None
    t_sample_mode: str = "uniform"  # or "logitnormal"

    def prior_logp(self, z):
        """Standard normal log-density of each sample."""
        n = math.prod(z.shape[1:])
        return -n / 2.0 * math.log(2 * math.pi) \
            - torch.sum(z.reshape(z.shape[0], -1) ** 2, -1) / 2.0

    def check_interval(self, train_eps, sample_eps, *, diffusion_form="SBDM",
                       sde=False, reverse=False, eval=False,
                       last_step_size=0.0):
        """(t0, t1) of the integration, as the JAX package chooses it."""
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if isinstance(self.path_sampler, path_mod.VPCPlan):
            t1 = 1 - eps if (not sde or last_step_size == 0) \
                else 1 - last_step_size
        elif (isinstance(self.path_sampler,
                         (path_mod.ICPlan, path_mod.GVPCPlan))
              and (self.model_type != ModelType.VELOCITY or sde)):
            t0 = eps if (diffusion_form == "SBDM" and sde) \
                or self.model_type != ModelType.VELOCITY else 0
            t1 = 1 - eps if (not sde or last_step_size == 0) \
                else 1 - last_step_size
        if reverse:
            t0, t1 = 1 - t0, 1 - t1
        return t0, t1

    def sample(self, x1, generator: Optional[torch.Generator] = None):
        """Draw (t, x0, x1) for training (transport.py:91-102): x0 ~ N(0, 1)
        like x1, t (N,) fp32 in the training interval, uniform or
        sigmoid(N(-0.5, 1)) scaled to it ("logitnormal")."""
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device,
                         dtype=x1.dtype)
        t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
        n = x1.shape[0]
        if self.t_sample_mode == "logitnormal":
            t = torch.randn(n, generator=generator, device=x1.device) - 0.5
            t = torch.sigmoid(t) * (t1 - t0) + t0
        elif self.t_sample_mode == "uniform":
            t = torch.rand(n, generator=generator, device=x1.device) \
                * (t1 - t0) + t0
        else:
            raise ValueError(f"t_sample_mode {self.t_sample_mode!r}")
        return t.float(), x0, x1

    def training_losses(self, model_fn: Callable, x1,
                        generator: Optional[torch.Generator] = None,
                        model_kwargs: Optional[Dict] = None):
        """Per-sample flow-matching loss (transport.py:104-133): draw
        (t, x0), build x_t and u_t from the plan, and return {"pred",
        "loss"}.  The velocity model's loss is mean_flat((pred - u_t)^2);
        the noise model's mean_flat(w (pred - x0)^2) and the score model's
        mean_flat(w (pred sigma_t + x0)^2), with w 1, (var / sigma_t)^2
        ("velocity") or var / sigma_t^2 ("likelihood").
        model_fn(x, t, **model_kwargs) -> prediction."""
        t, x0, x1 = self.sample(x1, generator)
        t, xt, ut = self.path_sampler.plan(t, x0, x1)
        pred = model_fn(xt, t, **(model_kwargs or {}))
        if self.model_type == ModelType.VELOCITY:
            return {"pred": pred, "loss": mean_flat((pred - ut) ** 2)}
        _, drift_var = self.path_sampler.compute_drift(xt, t)
        sigma_t, _ = self.path_sampler.compute_sigma_t(expand_t_like_x(t, xt))
        if self.loss_type == WeightType.VELOCITY:
            weight = (drift_var / sigma_t) ** 2
        elif self.loss_type == WeightType.LIKELIHOOD:
            weight = drift_var / (sigma_t ** 2)
        else:
            weight = 1.0
        if self.model_type == ModelType.NOISE:
            loss = mean_flat(weight * (pred - x0) ** 2)
        else:
            loss = mean_flat(weight * (pred * sigma_t + x0) ** 2)
        return {"pred": pred, "loss": loss}

    def get_drift(self):
        """Probability-flow ODE drift: drift(x, t, model_fn, **kw)."""
        plan = self.path_sampler

        def score_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = plan.compute_drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t, **kw)

        def noise_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = plan.compute_drift(x, t)
            sigma_t, _ = plan.compute_sigma_t(expand_t_like_x(t, x))
            score = model_fn(x, t, **kw) / -sigma_t
            return -drift_mean + drift_var * score

        def velocity_ode(x, t, model_fn, **kw):
            return model_fn(x, t, **kw)

        return {ModelType.NOISE: noise_ode, ModelType.SCORE: score_ode,
                ModelType.VELOCITY: velocity_ode}[self.model_type]

    def get_score(self):
        """Score from the model output: score(x, t, model_fn, **kw)."""
        plan = self.path_sampler
        if self.model_type == ModelType.NOISE:
            return lambda x, t, model_fn, **kw: model_fn(x, t, **kw) / \
                -plan.compute_sigma_t(expand_t_like_x(t, x))[0]
        if self.model_type == ModelType.SCORE:
            return lambda x, t, model_fn, **kw: model_fn(x, t, **kw)
        return lambda x, t, model_fn, **kw: plan.get_score_from_velocity(
            model_fn(x, t, **kw), x, t)


class Sampler:
    """Sampling front end.  Sample functions take (x_init, model_fn,
    **model_kwargs), plus the draws' source where there are draws, and
    return x(t1)."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

    # -- ODE -----------------------------------------------------------
    def sample_ode(self, *, sampling_method="dopri5", num_steps=50,
                   atol=1e-6, rtol=1e-3, reverse=False, return_nfe=False):
        """sample_fn(x, model_fn, **model_kwargs) -> x(t1); with dopri5 and
        `return_nfe`, (x(t1), NFE)."""
        if reverse:
            def drift_raw(x, t, model_fn, **kw):
                return self.drift(x, torch.ones_like(t) * (1 - t), model_fn,
                                  **kw)
        else:
            drift_raw = self.drift
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, sde=False,
            eval=True, reverse=reverse, last_step_size=0.0)
        if sampling_method not in ("dopri5", "euler", "Euler", "heun",
                                   "Heun"):
            raise NotImplementedError(sampling_method)

        def sample_fn(x, model_fn, **model_kwargs):
            def drift(x_, t_):
                return drift_raw(x_, t_, model_fn, **model_kwargs)
            if sampling_method == "dopri5":
                return ode_dopri5(drift, x, t0, t1, rtol=rtol, atol=atol,
                                  return_nfe=return_nfe)
            if sampling_method in ("euler", "Euler"):
                return ode_euler(drift, x, t0, t1, num_steps)
            return ode_heun(drift, x, t0, t1, num_steps)

        return sample_fn

    # -- SDE -----------------------------------------------------------
    def sample_sde(self, *, sampling_method="Euler", diffusion_form="SBDM",
                   diffusion_norm=1.0, last_step="Mean", last_step_size=0.04,
                   num_steps=250):
        """sample_fn(x, model_fn, generator=None, draw=None, **model_kwargs)
        -> x(t1): the stepper's noise from `draw(shape)` (a standard
        normal tensor) when given, else `torch.randn` on `generator`.
        Heun takes num_steps // 2 grid points.  A velocity or noise model's
        SDE drift calls the model twice a step (drift and score)."""
        if sampling_method not in ("Euler", "Heun"):
            raise NotImplementedError(sampling_method)
        if last_step not in (None, "Mean", "Tweedie", "Euler"):
            raise NotImplementedError(last_step)
        num_steps_eff = num_steps if sampling_method == "Euler" \
            else num_steps // 2
        if last_step is None:
            last_step_size = 0.0
        elif last_step_size == -1:
            last_step_size = 1.0 / num_steps_eff
        plan = self.transport.path_sampler

        def diffusion_fn(x, t):
            return plan.compute_diffusion(x, t, form=diffusion_form,
                                          norm=diffusion_norm)

        def sde_drift(x, t, model_fn, **kw):
            return self.drift(x, t, model_fn, **kw) + \
                diffusion_fn(x, t) * self.score(x, t, model_fn, **kw)

        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            diffusion_form=diffusion_form, sde=True, eval=True,
            reverse=False, last_step_size=last_step_size)

        def last_step_fn(x, t, model_fn, **kw):
            if last_step is None:
                return x
            if last_step == "Mean":
                return x + sde_drift(x, t, model_fn, **kw) * last_step_size
            if last_step == "Tweedie":
                td = expand_t_like_x(t, x)
                a = plan.compute_alpha_t(td)[0]
                s = plan.compute_sigma_t(td)[0]
                return x / a + (s ** 2) / a * self.score(x, t, model_fn, **kw)
            return x + self.drift(x, t, model_fn, **kw) * last_step_size

        stepper = sde_euler_maruyama if sampling_method == "Euler" \
            else sde_heun

        def sample_fn(x, model_fn, generator=None, draw=None,
                      **model_kwargs):
            def drift(x_, t_):
                return sde_drift(x_, t_, model_fn, **model_kwargs)
            xs = stepper(drift, diffusion_fn, x, t0, t1, num_steps_eff,
                         generator=generator, draw=draw)
            return last_step_fn(xs, _tvec(xs, t1), model_fn, **model_kwargs)

        return sample_fn

    # -- likelihood ------------------------------------------------------
    def augmented_drift(self, x, t, model_fn, eps, **model_kwargs):
        """One call of the likelihood's augmented drift at t (t_vec): the
        reverse ODE's dx/dt = -drift(x, 1 - t), and eps^T (d drift / d x),
        whose product with eps summed over a sample estimates the drift's
        divergence (Hutchinson).  The vector-Jacobian product is
        `torch.autograd.grad` with respect to x only (on CUDA the selective
        scan then takes its training kernels, which give the gradient);
        the model runs as it is called (eval mode: no label dropout, no
        drop path)."""
        t_rev = torch.ones_like(t) * (1 - t)
        with torch.inference_mode(False), torch.enable_grad():
            z = x.detach().clone().requires_grad_(True)
            drift_val = self.drift(z, t_rev, model_fn, **model_kwargs)
            (vjp,) = torch.autograd.grad(drift_val, z, grad_outputs=eps)
        return -drift_val.detach(), vjp

    def sample_ode_likelihood(self, *, sampling_method="dopri5",
                              num_steps=50, atol=1e-6, rtol=1e-3):
        """sample_fn(x, model_fn, generator=None, eps=None, **model_kwargs)
        -> (log p(x), x(t1)).

        The augmented reverse ODE (`augmented_drift`), integrated by
        fixed-step Euler over max(num_steps, 2) grid points as the JAX
        package does whatever the method, with one Rademacher probe `eps`
        for the whole run (drawn from `generator` unless given).  The
        method and tolerances are accepted for the JAX signature's sake."""
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, sde=False,
            eval=True, reverse=False, last_step_size=0.0)

        def sample_fn(x, model_fn, generator=None, eps=None, **model_kwargs):
            if eps is None:
                eps = torch.randint(0, 2, x.shape, generator=generator,
                                    device=x.device).float() * 2 - 1
            eps = eps.to(device=x.device, dtype=torch.float32)
            dims = tuple(range(1, x.ndim))
            xs = x.detach()
            logp = torch.zeros(x.shape[0], dtype=torch.float32,
                               device=x.device)
            ts = _grid(t0, t1, max(num_steps, 2), x.device)
            for i in range(len(ts) - 1):
                dt = ts[i + 1] - ts[i]
                dx, vjp = self.augmented_drift(xs, _tvec(xs, ts[i]),
                                               model_fn, eps, **model_kwargs)
                xs = xs + dt * dx
                logp = logp + dt * torch.sum(vjp * eps, dim=dims)
            return self.transport.prior_logp(xs) - logp, xs

        return sample_fn
