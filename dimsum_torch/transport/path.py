"""Coupling plans (interpolants), port of `dimsum_tpu/transport/path.py`:
alpha_t multiplies the data, sigma_t the noise, and time runs noise (t=0)
-> data (t=1).  The Linear (IC), VP and GVP plans, with the SDE pieces
(drift, diffusion) and the conversions between the velocity, score and
noise parametrizations.  With `use_blurring` the data side of the
interpolant is blurred in the DCT domain first (`dct_blur`, the JAX
path.py:23-33, :114-117).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dimsum_torch.ops.dct import dct_2d, idct_2d


def expand_t_like_x(t, x):
    """(B,) -> (B, 1, 1, ...) matching x's rank."""
    return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))


def dct_blur(x, patch_size: int, blur_sigmas, min_scale: float = 1e-3):
    """Frequency-domain blur of x (B, C, H, W): patchwise orthonormal DCT,
    each frequency (u, v) of a patch scaled by exp(-(pi^2 (u^2 + v^2) /
    p^2) sigma^2 / 2) (1 - min_scale) + min_scale, inverse DCT.
    `blur_sigmas` broadcasts against the patches' coefficients."""
    freqs = math.pi * torch.linspace(0, patch_size - 1, patch_size,
                                     device=x.device) / patch_size
    freq_sq = freqs[:, None] ** 2 + freqs[None, :] ** 2
    t_blur = torch.as_tensor(blur_sigmas, device=x.device) ** 2 / 2.0
    coefs = dct_2d(x, patch_size, norm="ortho")
    scale = x.shape[-1] // patch_size
    mask = freq_sq.tile(scale, scale)
    attenuation = torch.exp(-mask * t_blur) * (1 - min_scale) + min_scale
    return idct_2d(coefs * attenuation, patch_size, norm="ortho")


@dataclasses.dataclass(frozen=True)
class ICPlan:
    """Linear coupling: alpha_t = t, sigma_t = 1 - t.  Each compute_*_t
    returns (value, d/dt value)."""

    sigma: float = 0.0
    use_blurring: bool = False
    blur_sigma_max: float = 3.0
    blur_upscale: int = 4

    # -- schedule ----------------------------------------------------------
    def compute_alpha_t(self, t):
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t):
        return 1 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t):
        return 1 / t

    # -- SDE pieces ---------------------------------------------------------
    def compute_drift(self, x, t):
        """(-drift_mean, diffusion_var) in the score parametrization."""
        t = expand_t_like_x(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        drift = alpha_ratio * x
        diffusion = alpha_ratio * (sigma_t ** 2) - sigma_t * d_sigma_t
        return -drift, diffusion

    def compute_diffusion(self, x, t, form: str = "constant",
                          norm: float = 1.0):
        """The SDE's diffusion coefficient g(t), (B, 1, ...), by form."""
        t = expand_t_like_x(t, x)
        choices = {
            "none": lambda: torch.zeros_like(t),
            "constant": lambda: torch.full_like(t, norm),
            "SBDM": lambda: norm * 2.0 * self._diffusion_sbdm(x, t),
            "sigma": lambda: norm * self.compute_sigma_t(t)[0],
            "linear": lambda: norm * (1 - t),
            "decreasing":
                lambda: 0.25 * (norm * torch.cos(math.pi * t) + 1) ** 2,
            "increasing-decreasing":
                lambda: norm * torch.sin(math.pi * t) ** 2,
            "log": lambda: norm * torch.log(t - t ** 2 + 1),
        }
        if form not in choices:
            raise NotImplementedError(f"Diffusion form {form}")
        return choices[form]()

    def _diffusion_sbdm(self, x, t_expanded):
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t_expanded)
        sigma_t, d_sigma_t = self.compute_sigma_t(t_expanded)
        return alpha_ratio * (sigma_t ** 2) - sigma_t * d_sigma_t

    # -- parametrization conversions ----------------------------------------
    def get_score_from_velocity(self, velocity, x, t):
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t ** 2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_noise_from_velocity(self, velocity, x, t):
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = reverse_alpha_ratio * d_sigma_t - sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_velocity_from_score(self, score, x, t):
        drift, var = self.compute_drift(x, t)
        return var * score - drift

    # -- interpolant ---------------------------------------------------------
    def compute_xt(self, t, x0, x1):
        """x_t = alpha_t x1 + sigma_t x0, x1 first blurred by `dct_blur`
        at sigma = blur_sigma_max sin(sigma_t pi / 2)^2 with
        `use_blurring` (the JAX `compute_mu_t`)."""
        t = expand_t_like_x(t, x1)
        alpha_t, _ = self.compute_alpha_t(t)
        sigma_t, _ = self.compute_sigma_t(t)
        if self.use_blurring:
            blur_sigmas = self.blur_sigma_max * torch.sin(
                sigma_t * math.pi / 2) ** 2
            x1 = dct_blur(x1, self.blur_upscale, blur_sigmas)
        return alpha_t * x1 + sigma_t * x0

    def compute_ut(self, t, x0, x1, xt):
        """u_t = alpha'_t x1 + sigma'_t x0 (the unblurred x1, as JAX)."""
        t = expand_t_like_x(t, x1)
        _, d_alpha_t = self.compute_alpha_t(t)
        _, d_sigma_t = self.compute_sigma_t(t)
        return d_alpha_t * x1 + d_sigma_t * x0

    def plan(self, t, x0, x1):
        """(t, x_t, u_t), t (N,) broadcast over x's other axes (the JAX
        `plan`, path.py:110-132)."""
        xt = self.compute_xt(t, x0, x1)
        return t, xt, self.compute_ut(t, x0, x1, xt)


@dataclasses.dataclass(frozen=True)
class VPCPlan(ICPlan):
    """VP path: log alpha_t = -(1 - t)^2 (s_max - s_min) / 4
    - (1 - t) s_min / 2, sigma_t = sqrt(1 - alpha_t^2)."""

    sigma_min: float = 0.1
    sigma_max: float = 20.0

    def _log_mean_coeff(self, t):
        return (-0.25 * ((1 - t) ** 2) * (self.sigma_max - self.sigma_min)
                - 0.5 * (1 - t) * self.sigma_min)

    def _d_log_mean_coeff(self, t):
        return (0.5 * (1 - t) * (self.sigma_max - self.sigma_min)
                + 0.5 * self.sigma_min)

    def compute_alpha_t(self, t):
        alpha_t = torch.exp(self._log_mean_coeff(t))
        return alpha_t, alpha_t * self._d_log_mean_coeff(t)

    def compute_sigma_t(self, t):
        p = 2 * self._log_mean_coeff(t)
        sigma_t = torch.sqrt(1 - torch.exp(p))
        d_sigma_t = torch.exp(p) * (2 * self._d_log_mean_coeff(t)) / (
            -2 * sigma_t)
        return sigma_t, d_sigma_t

    def compute_d_alpha_alpha_ratio_t(self, t):
        return self._d_log_mean_coeff(t)

    def compute_drift(self, x, t):
        t = expand_t_like_x(t, x)
        beta_t = self.sigma_min + (1 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2


@dataclasses.dataclass(frozen=True)
class GVPCPlan(ICPlan):
    """GVP path: alpha = sin(pi t / 2), sigma = cos(pi t / 2), the
    published DiMSUM configuration."""

    def compute_alpha_t(self, t):
        return (torch.sin(t * math.pi / 2),
                math.pi / 2 * torch.cos(t * math.pi / 2))

    def compute_sigma_t(self, t):
        return (torch.cos(t * math.pi / 2),
                -math.pi / 2 * torch.sin(t * math.pi / 2))

    def compute_d_alpha_alpha_ratio_t(self, t):
        return math.pi / (2 * torch.tan(t * math.pi / 2))
