"""ODE and SDE integrators, port of `dimsum_tpu/transport/integrators.py`:
fixed-step Euler and Heun, the adaptive Dormand-Prince 5(4) with the JAX
package's step control and NFE count, and the Euler-Maruyama and Heun SDE
steppers.

Drift signature: drift(x, t_vec) -> dx/dt, with t_vec shaped (batch,).
Times are float32, as the JAX package holds them: the fixed grids come from
`linspace` in float32, and dopri5 keeps t, dt and the t < t1 test in 0-d
float32 tensors on x's device, so that each accept or reject, the last
clipped step and so the NFE are decided in the same arithmetic.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _grid(t0: float, t1: float, num_steps: int, device=None):
    """linspace(t0, t1, num_steps) in float32."""
    return torch.linspace(t0, t1, num_steps, dtype=torch.float32,
                          device=device)


def _tvec(x, t):
    """t (a Python number or a 0-d tensor) as a (batch,) float32 vector on
    x's device."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).reshape(1).expand(x.shape[0])
    return torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Fixed-step ODE
# ---------------------------------------------------------------------------


def _grid_lists(t0: float, t1: float, num_steps: int):
    """(times, step sizes) of the float32 grid, as Python floats."""
    ts = _grid(t0, t1, num_steps)
    return ts.tolist(), (ts[1:] - ts[:-1]).tolist()


def ode_euler(drift, x, t0: float, t1: float, num_steps: int):
    """Euler over linspace(t0, t1, num_steps): num_steps - 1 drift calls."""
    ts, dts = _grid_lists(t0, t1, num_steps)
    for t, dt in zip(ts, dts):
        x = x + dt * drift(x, _tvec(x, t))
    return x


def ode_heun(drift, x, t0: float, t1: float, num_steps: int):
    ts, dts = _grid_lists(t0, t1, num_steps)
    for t, t_next, dt in zip(ts, ts[1:], dts):
        k1 = drift(x, _tvec(x, t))
        k2 = drift(x + dt * k1, _tvec(x, t_next))
        x = x + dt * 0.5 * (k1 + k2)
    return x


# ---------------------------------------------------------------------------
# Adaptive Dormand-Prince 5(4)
# ---------------------------------------------------------------------------

# Butcher tableau (standard DOPRI5), each coefficient rounded to float32 as
# the JAX package's float32 arithmetic takes it
def _f32(v):
    return float(np.float32(v))


_C = [_f32(c) for c in (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)]
_A = [[_f32(a) for a in row] for row in (
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
)]
_B5 = [_f32(b) for b in (35 / 384, 0.0, 500 / 1113, 125 / 192,
                         -2187 / 6784, 11 / 84, 0.0)]
_B4 = [_f32(b) for b in (5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                         -92097 / 339200, 187 / 2100, 1 / 40)]


def _rms(v):
    """sqrt(mean(v^2)) over the whole tensor (one norm for the batch)."""
    return torch.sqrt(torch.mean(v ** 2))


def _weighted_sum(b, ks):
    """sum_i b[i] * ks[i], accumulated left to right."""
    acc = b[0] * ks[0]
    for bi, k in zip(b[1:], ks[1:]):
        acc = acc + bi * k
    return acc


def ode_dopri5(drift, x, t0: float, t1: float, rtol: float = 1e-3,
               atol: float = 1e-6, max_steps: int = 10_000,
               first_dt: Optional[float] = None, return_nfe: bool = False):
    """Adaptive RK45 with the standard step-size controller, from t0 to t1
    (t1 > t0); returns x(t1), and the NFE with `return_nfe`.

    As the JAX `ode_dopri5` (its `lax.while_loop`):
      * the NFE starts at 1 for the first drift call and adds 6 for every
        attempted step, accepted or rejected; without `first_dt`, Hairer's
        initial-step probe makes one more drift call, not counted;
      * the error norm is one RMS over the whole batch;
      * a rejected step keeps x and the FSAL stage;
      * the loop stops at t >= t1 or at NFE >= 6 * max_steps.
    Eager PyTorch decides whether to go on on the host: one read of a
    device scalar (t < t1) per attempted step.  The accept decision and the
    new state stay on the device."""
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    t0_ = torch.tensor(t0, **f32)
    t1_ = torch.tensor(t1, **f32)

    def f(x_, t_):
        return drift(x_, _tvec(x_, t_))

    k1_init = f(x, t0_)

    if first_dt is not None:
        dt = torch.tensor(first_dt, **f32)
    else:
        # Hairer's automatic initial step (torchdiffeq/diffrax): one extra
        # drift call
        scale = atol + rtol * torch.abs(x)
        d0 = _rms(x / scale)
        d1 = _rms(k1_init / scale)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                         torch.tensor(1e-6, **f32), 0.01 * d0 / d1)
        f1 = f(x + h0 * k1_init, t0_ + h0)
        d2 = _rms((f1 - k1_init) / scale) / h0
        dmax = torch.maximum(d1, d2)
        h1 = torch.where(dmax <= 1e-15,
                         torch.maximum(torch.tensor(1e-6, **f32), h0 * 1e-3),
                         (0.01 / dmax) ** 0.2)
        dt = torch.minimum(torch.minimum(100 * h0, h1),
                           torch.tensor(t1 - t0, **f32))

    t, k_last, nfe = t0_, k1_init, 1
    while nfe < max_steps * 6 and bool(t < t1_):
        dt = torch.minimum(dt, t1_ - t)
        ks = [k_last]  # FSAL
        for i in range(1, 7):
            xi = x
            for j, aij in enumerate(_A[i]):
                xi = xi + dt * aij * ks[j]
            ks.append(f(xi, t + _C[i] * dt))
        x5 = x + dt * _weighted_sum(_B5, ks)
        x4 = x + dt * _weighted_sum(_B4, ks)

        scale = atol + rtol * torch.maximum(torch.abs(x), torch.abs(x5))
        err_norm = _rms((x5 - x4) / scale)
        accept = err_norm <= 1.0
        factor = torch.clamp(
            0.9 * (1.0 / torch.clamp(err_norm, min=1e-10)) ** 0.2, 0.2, 10.0)
        t = torch.where(accept, t + dt, t)
        x = torch.where(accept, x5, x)
        k_last = torch.where(accept, ks[6], k_last)
        dt = dt * factor
        nfe += 6
    return (x, nfe) if return_nfe else x


# ---------------------------------------------------------------------------
# SDE
# ---------------------------------------------------------------------------


def _draw_fn(generator: Optional[torch.Generator],
             draw: Optional[Callable]) -> Callable:
    """The SDE steppers' one source of noise: `draw(shape)` -> a standard
    normal tensor; by default `torch.randn` on `generator` (on the
    generator's device, as float32)."""
    if draw is not None:
        return draw
    dev = generator.device if generator is not None else None
    return lambda shape: torch.randn(shape, generator=generator, device=dev)


def sde_euler_maruyama(drift, diffusion, x, t0: float, t1: float,
                       num_steps: int,
                       generator: Optional[torch.Generator] = None,
                       draw: Optional[Callable] = None):
    """Euler-Maruyama over linspace(t0, t1, num_steps), iterating t[:-1]:
    x <- x + drift dt + sqrt(2 g) sqrt(dt) w, one draw w per step.  Returns
    x after the loop (the caller applies the last-step function at t1)."""
    ts = _grid(t0, t1, num_steps, x.device)
    dt = ts[1] - ts[0]
    sqrt_dt = torch.sqrt(dt)
    draw = _draw_fn(generator, draw)
    for i in range(num_steps - 1):
        t = _tvec(x, ts[i])
        dw = draw(x.shape).to(device=x.device, dtype=x.dtype) * sqrt_dt
        mean_x = x + drift(x, t) * dt
        x = mean_x + torch.sqrt(2 * diffusion(x, t)) * dw
    return x


def sde_heun(drift, diffusion, x, t0: float, t1: float, num_steps: int,
             generator: Optional[torch.Generator] = None,
             draw: Optional[Callable] = None):
    """Heun SDE stepper over the same grid: the noise first, then a Heun
    step of the drift from the noised point."""
    ts = _grid(t0, t1, num_steps, x.device)
    dt = ts[1] - ts[0]
    sqrt_dt = torch.sqrt(dt)
    draw = _draw_fn(generator, draw)
    for i in range(num_steps - 1):
        t = _tvec(x, ts[i])
        dw = draw(x.shape).to(device=x.device, dtype=x.dtype) * sqrt_dt
        xhat = x + torch.sqrt(2 * diffusion(x, t)) * dw
        k1 = drift(xhat, t)
        xp = xhat + dt * k1
        k2 = drift(xp, _tvec(x, ts[i] + dt))
        x = xhat + 0.5 * dt * (k1 + k2)
    return x
