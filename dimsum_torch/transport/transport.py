"""Transport (flow matching), port of `dimsum_tpu/transport/transport.py`:
the time interval, the training draws and the velocity model's loss, the
velocity model's probability-flow ODE drift, and `Sampler.sample_ode` with
Euler and Heun.  The noise and score drifts and loss weightings, SDE
sampling, likelihoods and dopri5 are not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Optional

import torch

from dimsum_torch.transport.integrators import ode_euler, ode_heun


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()


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

    def check_interval(self, train_eps, sample_eps, *, diffusion_form="SBDM",
                       sde=False, reverse=False, eval=False,
                       last_step_size=0.0):
        """(t0, t1) of the integration, as the JAX package chooses it for
        the linear and GVP plans."""
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if self.model_type != ModelType.VELOCITY or sde:
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
        """Per-sample flow-matching loss (transport.py:104-117): draw
        (t, x0), build x_t and u_t from the plan, and return {"pred",
        "loss"} with loss = mean_flat((model_fn(x_t, t) - u_t)^2) for the
        velocity model.  model_fn(x, t, **model_kwargs) -> prediction."""
        if self.model_type != ModelType.VELOCITY:
            raise NotImplementedError(
                f"{self.model_type}: only the velocity loss is ported")
        t, x0, x1 = self.sample(x1, generator)
        t, xt, ut = self.path_sampler.plan(t, x0, x1)
        pred = model_fn(xt, t, **(model_kwargs or {}))
        return {"pred": pred, "loss": mean_flat((pred - ut) ** 2)}

    def get_drift(self):
        """Probability-flow ODE drift: drift(x, t, model_fn, **kw).  For a
        velocity model it is the model's output."""
        if self.model_type != ModelType.VELOCITY:
            raise NotImplementedError(
                f"{self.model_type}: only the velocity drift is ported")

        def velocity_ode(x, t, model_fn, **kw):
            return model_fn(x, t, **kw)

        return velocity_ode


class Sampler:
    """Sampling front end.  Sample functions take (x_init, model_fn,
    **model_kwargs) and return x(t1)."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()

    def sample_ode(self, *, sampling_method="euler", num_steps=50):
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, sde=False,
            eval=True, reverse=False, last_step_size=0.0)
        if sampling_method in ("euler", "Euler"):
            integrate = ode_euler
        elif sampling_method in ("heun", "Heun"):
            integrate = ode_heun
        else:
            raise NotImplementedError(
                f"sampling_method {sampling_method!r}: euler and heun are "
                "ported, dopri5 is not yet")

        def sample_fn(x, model_fn, **model_kwargs):
            def drift(x_, t_):
                return self.drift(x_, t_, model_fn, **model_kwargs)
            return integrate(drift, x, t0, t1, num_steps)

        return sample_fn
