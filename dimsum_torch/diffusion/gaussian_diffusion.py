"""ADM-style Gaussian diffusion (DDPM / DDIM), PyTorch port of
`dimsum_tpu/diffusion/gaussian_diffusion.py` (the guided-diffusion stack
the reference vendors: gaussian_diffusion.py, respace.py,
timestep_sampler.py).

The schedule is computed once in float64 numpy, as in JAX, and each
coefficient is gathered by timestep as float32.  Random draws come from an
explicit `torch.Generator`; every function that draws also takes the draw
itself (`noise=`, or `draw=` for the sampling loops), so that a test can
feed it the JAX package's draws.  Tensors are (N, C, ...) with the
timestep t (N,) int64 on the same device.
"""

from __future__ import annotations

import enum
import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from dimsum_torch.utils.device import resolve_device

__all__ = ["ModelMeanType", "ModelVarType", "LossType",
           "get_named_beta_schedule", "GaussianDiffusion", "space_timesteps",
           "spaced_diffusion", "UniformSampler", "LossSecondMomentResampler",
           "mean_flat", "normal_kl", "discretized_gaussian_log_likelihood"]


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """"linear" (ADM's, scaled by 1000 / num_steps) or "cosine" (Nichol &
    Dhariwal, clipped at 0.999), float64."""
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 1e-4, scale * 2e-2, num_steps,
                           dtype=np.float64)
    if name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = []
        for i in range(num_steps):
            t1, t2 = i / num_steps, (i + 1) / num_steps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.array(betas, np.float64)
    raise NotImplementedError(name)


def _extract(arr: np.ndarray, t, shape):
    """Per-timestep scalars of `arr`, as float32, gathered at t and shaped
    to broadcast over `shape`."""
    out = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)[t]
    return out.reshape(t.shape[0], *([1] * (len(shape) - 1)))


def mean_flat(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _norm_cdf(x):
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of x in [-1, 1] under a Gaussian discretized to 256
    bins (ADM's decoder term)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _norm_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _norm_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp_min(1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp_min(1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp_min(1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


class GaussianDiffusion:
    """The JAX `GaussianDiffusion`: q (forward noising), the posterior, p
    (the model's reverse step), the DDPM and DDIM sampling loops and the
    training losses.  `model_fn(x, t, **model_kwargs)` returns the model
    output: eps or x_0, with the variance's C channels after it for the
    learned variance types."""

    def __init__(self, *, betas: np.ndarray,
                 model_mean_type=ModelMeanType.EPSILON,
                 model_var_type=ModelVarType.FIXED_SMALL,
                 loss_type=LossType.MSE):
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        betas = np.asarray(betas, np.float64)
        self.betas = betas
        self.num_timesteps = len(betas)
        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        # a linear schedule of few steps drives beta past 1 and the
        # cumulative product through 0: those entries are inf / nan, as in
        # the reference's table, without numpy's warnings
        with np.errstate(divide="ignore", invalid="ignore"):
            self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
            self.sqrt_one_minus_alphas_cumprod = np.sqrt(
                1.0 - self.alphas_cumprod)
            self.sqrt_recip_alphas_cumprod = np.sqrt(
                1.0 / self.alphas_cumprod)
            self.sqrt_recipm1_alphas_cumprod = np.sqrt(
                1.0 / self.alphas_cumprod - 1)
            self.posterior_variance = (
                betas * (1.0 - self.alphas_cumprod_prev)
                / (1.0 - self.alphas_cumprod))
            self.posterior_log_variance_clipped = np.log(
                np.append(self.posterior_variance[1],
                          self.posterior_variance[1:]))
            self.posterior_mean_coef1 = (
                betas * np.sqrt(self.alphas_cumprod_prev)
                / (1.0 - self.alphas_cumprod))
            self.posterior_mean_coef2 = (
                (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas)
                / (1.0 - self.alphas_cumprod))
            self.log_betas = np.log(betas)
            large = np.append(self.posterior_variance[1], betas[1:])
            self.large_variance, self.large_log_variance = large, np.log(large)

    # -- q --------------------------------------------------------------
    def q_sample(self, x_start, t, noise):
        return (_extract(self.sqrt_alphas_cumprod, t, x_start.shape) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t,
                           x_start.shape) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (_extract(self.posterior_mean_coef1, t, x_t.shape) * x_start
                + _extract(self.posterior_mean_coef2, t, x_t.shape) * x_t)
        var = _extract(self.posterior_variance, t, x_t.shape)
        logvar = _extract(self.posterior_log_variance_clipped, t, x_t.shape)
        return mean, var, logvar

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (_extract(self.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, x_t.shape)
                * eps)

    def _predict_eps_from_xstart(self, x_t, t, x_start):
        return ((_extract(self.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t
                 - x_start)
                / _extract(self.sqrt_recipm1_alphas_cumprod, t, x_t.shape))

    # -- p --------------------------------------------------------------
    def p_mean_variance(self, model_fn, x, t, clip_denoised=True,
                        model_kwargs=None) -> Dict[str, torch.Tensor]:
        out = model_fn(x, t, **(model_kwargs or {}))
        C = x.shape[1]
        if self.model_var_type in (ModelVarType.LEARNED,
                                   ModelVarType.LEARNED_RANGE):
            out, var_raw = out[:, :C], out[:, C:]
            if self.model_var_type == ModelVarType.LEARNED:
                model_logvar = var_raw
            else:
                min_log = _extract(self.posterior_log_variance_clipped, t,
                                   x.shape)
                max_log = _extract(self.log_betas, t, x.shape)
                frac = (var_raw + 1) / 2
                model_logvar = frac * max_log + (1 - frac) * min_log
            model_var = torch.exp(model_logvar)
        elif self.model_var_type == ModelVarType.FIXED_SMALL:
            model_var = _extract(self.posterior_variance, t, x.shape)
            model_logvar = _extract(self.posterior_log_variance_clipped, t,
                                    x.shape)
        else:  # FIXED_LARGE
            model_var = _extract(self.large_variance, t, x.shape)
            model_logvar = _extract(self.large_log_variance, t, x.shape)

        def clip(v):
            return v.clamp(-1, 1) if clip_denoised else v

        if self.model_mean_type == ModelMeanType.EPSILON:
            x_start = clip(self._predict_xstart_from_eps(x, t, out))
        elif self.model_mean_type == ModelMeanType.START_X:
            x_start = clip(out)
        else:
            raise NotImplementedError(self.model_mean_type)
        mean, _, _ = self.q_posterior_mean_variance(x_start, x, t)
        return {"mean": mean, "variance": model_var,
                "log_variance": model_logvar, "pred_xstart": x_start}

    def p_sample(self, model_fn, x, t, generator=None, clip_denoised=True,
                 model_kwargs=None, noise=None):
        """x_{t-1} from x_t: the posterior mean, plus exp(logvar / 2) noise
        where t > 0 (`noise`, or a draw from `generator`)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised,
                                   model_kwargs)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        return out["mean"] + nonzero * torch.exp(
            0.5 * out["log_variance"]) * noise

    def _loop(self, step, shape, generator, draw, device):
        """x_T ~ N(0, I), then `step(x, t, noise)` for t = T-1 .. 0; every
        draw through `draw(shape)` (default: `generator` on `device`)."""
        device = resolve_device(device)
        if draw is None:
            def draw(s):
                return torch.randn(s, generator=generator, device=device)
        x = draw(shape)
        for i in reversed(range(self.num_timesteps)):
            t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
            x = step(x, t, draw(shape))
        return x

    @torch.no_grad()
    def p_sample_loop(self, model_fn, shape, generator=None,
                      clip_denoised=True, model_kwargs=None,
                      draw: Optional[Callable] = None, device="cuda"):
        """Ancestral (DDPM) sampling from x_T ~ N(0, I) on `device`, all
        num_timesteps steps."""
        return self._loop(
            lambda x, t, noise: self.p_sample(
                model_fn, x, t, clip_denoised=clip_denoised,
                model_kwargs=model_kwargs, noise=noise),
            shape, generator, draw, device)

    def _ddim_step(self, model_fn, x, t, noise, eta=0.0, clip_denoised=True,
                  model_kwargs=None):
        """One DDIM step (eta 0: deterministic; the noise then has no
        effect)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised,
                                   model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        ab = _extract(self.alphas_cumprod, t, x.shape)
        ab_prev = _extract(self.alphas_cumprod_prev, t, x.shape)
        sigma = (eta * torch.sqrt((1 - ab_prev) / (1 - ab))
                 * torch.sqrt(1 - ab / ab_prev))
        mean = (out["pred_xstart"] * torch.sqrt(ab_prev)
                + torch.sqrt(1 - ab_prev - sigma ** 2) * eps)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        return mean + nonzero * sigma * noise

    @torch.no_grad()
    def ddim_sample_loop(self, model_fn, shape, generator=None, eta=0.0,
                         clip_denoised=True, model_kwargs=None,
                         draw: Optional[Callable] = None, device="cuda"):
        """DDIM sampling from x_T ~ N(0, I) on `device` (a step's noise is
        drawn even at eta 0, as JAX draws it)."""
        return self._loop(
            lambda x, t, noise: self._ddim_step(
                model_fn, x, t, noise, eta=eta, clip_denoised=clip_denoised,
                model_kwargs=model_kwargs),
            shape, generator, draw, device)

    # -- losses ----------------------------------------------------------
    def training_losses(self, model_fn, x_start, t, generator=None,
                        model_kwargs=None, noise=None) -> Dict[str, Any]:
        """{"loss", and "mse" / "vb" by loss type} per example, for x_t =
        q_sample(x_start, t, noise) with `noise` (or a draw from
        `generator`)."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device, dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, Any] = {}
        if self.loss_type in (LossType.MSE, LossType.RESCALED_MSE):
            out = model_fn(x_t, t, **(model_kwargs or {}))
            C = x_start.shape[1]
            if self.model_var_type in (ModelVarType.LEARNED,
                                       ModelVarType.LEARNED_RANGE):
                out, var_raw = out[:, :C], out[:, C:]
                # the vb term with the mean frozen (ADM's detached mean)
                frozen = torch.cat([out.detach(), var_raw], dim=1)
                terms["vb"] = self._vb_terms(lambda *a, **k: frozen,
                                             x_start, x_t, t)
            target = {ModelMeanType.EPSILON: noise,
                      ModelMeanType.START_X: x_start}[self.model_mean_type]
            terms["mse"] = mean_flat((target - out) ** 2)
            terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
        else:
            terms["loss"] = self._vb_terms(
                lambda x, tt, **k: model_fn(x, tt, **(model_kwargs or {})),
                x_start, x_t, t)
        return terms

    def _vb_terms(self, model_fn, x_start, x_t, t):
        true_mean, _, true_logvar = self.q_posterior_mean_variance(
            x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t)
        kl = mean_flat(normal_kl(true_mean, true_logvar, out["mean"],
                                 out["log_variance"])) / math.log(2.0)
        nll = -mean_flat(discretized_gaussian_log_likelihood(
            x_start, out["mean"], 0.5 * out["log_variance"])) / math.log(2.0)
        return torch.where(t == 0, nll, kl)


# ---------------------------------------------------------------------------
# respacing + timestep samplers
# ---------------------------------------------------------------------------


def space_timesteps(num_timesteps: int, section_counts) -> Sequence[int]:
    """respace.py: "ddimN" (a stride that gives exactly N steps) or
    comma-separated counts, one section of the timesteps each."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} ddim steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start, taken = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if count > size:
            raise ValueError(f"cannot take {count} from {size}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            taken.append(start + round(cur))
            cur += stride
        start += size
    return taken


def spaced_diffusion(base_betas: np.ndarray, use_timesteps,
                     **kwargs) -> GaussianDiffusion:
    """A GaussianDiffusion over a subset of the base schedule's timesteps,
    with the betas that keep its cumulative products at those steps."""
    use_timesteps = sorted(set(use_timesteps))
    alphas_cumprod = np.cumprod(1.0 - np.asarray(base_betas, np.float64))
    last = 1.0
    new_betas = []
    for i in use_timesteps:
        new_betas.append(1 - alphas_cumprod[i] / last)
        last = alphas_cumprod[i]
    return GaussianDiffusion(betas=np.array(new_betas), **kwargs)


class UniformSampler:
    def __init__(self, diffusion: GaussianDiffusion):
        self.n = diffusion.num_timesteps

    def sample(self, batch: int, generator=None, device="cuda"):
        """(t (batch,) int64 uniform in [0, n), weights 1) on `device`."""
        device = resolve_device(device)
        t = torch.randint(0, self.n, (batch,), generator=generator,
                          device=device)
        return t, torch.ones(batch, device=device)


class LossSecondMomentResampler:
    """Importance-samples timesteps by the root mean square of their last
    `history` losses (timestep_sampler.py), uniform until every timestep
    has its history."""

    def __init__(self, diffusion: GaussianDiffusion, history: int = 10,
                 uniform_prob: float = 1e-3):
        self.n = diffusion.num_timesteps
        self.history = history
        self.uniform_prob = uniform_prob
        self._losses = np.zeros((self.n, history), np.float64)
        self._counts = np.zeros(self.n, np.int64)

    def weights(self) -> np.ndarray:
        if not (self._counts == self.history).all():
            return np.ones(self.n) / self.n
        w = np.sqrt(np.mean(self._losses ** 2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.n

    def sample(self, batch: int, generator=None, device="cuda"):
        """(t (batch,) int64 drawn by the weights, their importance
        weights 1 / (n w_t) as float32) on `device`; the draw is made on
        the host, from `generator` (a CPU generator), as the weights live
        there."""
        device = resolve_device(device)
        w = self.weights()
        t = torch.multinomial(torch.as_tensor(w), batch, replacement=True,
                              generator=generator).to(device)
        inv = torch.as_tensor(1.0 / (self.n * w), dtype=torch.float32)
        return t, inv.to(device)[t]

    def update(self, ts, losses):
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._counts[t] == self.history:
                self._losses[t, :-1] = self._losses[t, 1:]
                self._losses[t, -1] = loss
            else:
                self._losses[t, self._counts[t]] = loss
                self._counts[t] += 1
