"""Fixed-step ODE integrators, port of `dimsum_tpu/transport/integrators.py`
(:33-85).  The adaptive dopri5 is not ported yet.

Drift signature: drift(x, t_vec) -> dx/dt, with t_vec shaped (batch,).
The time grid is float32, as `jnp.linspace` makes it in the JAX package.
"""

from __future__ import annotations

import torch


def _grid(t0: float, t1: float, num_steps: int):
    """(times, step sizes) of linspace(t0, t1, num_steps) in float32."""
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    return ts.tolist(), (ts[1:] - ts[:-1]).tolist()


def _tvec(x, t: float):
    return torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)


def ode_euler(drift, x, t0: float, t1: float, num_steps: int):
    """Euler over linspace(t0, t1, num_steps): num_steps - 1 drift calls."""
    ts, dts = _grid(t0, t1, num_steps)
    for t, dt in zip(ts, dts):
        x = x + dt * drift(x, _tvec(x, t))
    return x


def ode_heun(drift, x, t0: float, t1: float, num_steps: int):
    ts, dts = _grid(t0, t1, num_steps)
    for t, t_next, dt in zip(ts, ts[1:], dts):
        k1 = drift(x, _tvec(x, t))
        k2 = drift(x + dt * k1, _tvec(x, t_next))
        x = x + dt * 0.5 * (k1 + k2)
    return x
