"""The reference's side of a sampling cell: its CFG forward in blocks of
rows, the Euler grid, and the control's sampler.  Plain PyTorch; imports
nothing of the port."""

from __future__ import annotations

import torch


def interval(path: str, prediction: str):
    """(t0, t1) of the probability-flow ODE: noise at 0, data at 1, with
    no epsilon for a velocity model on the Linear or GVP path."""
    if path in ("GVP", "Linear") and prediction == "velocity":
        return 0.0, 1.0
    raise NotImplementedError(f"{path} / {prediction}")


def grid(path: str, prediction: str, num_steps: int):
    """The Euler grid's float32 times and their steps, as Python
    floats."""
    t0, t1 = interval(path, prediction)
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    return ts.tolist(), (ts[1:] - ts[:-1]).tolist()


def cfg_forward(model, x, t, y, scale: float, in_channels: int,
                block: int):
    """The drift of classifier-free guidance on the doubled batch
    [half; half] with y [labels; null]: the guided first `in_channels`
    (a learned variance's channels are not part of it), the model run
    `block` rows at a time (its rows are independent), in float32."""
    half = x[: x.shape[0] // 2].float()
    xin, tf = torch.cat([half, half]), t.float()
    out = torch.cat([model(xin[i:i + block], tf[i:i + block],
                           y[i:i + block])
                     for i in range(0, xin.shape[0], block)])
    cond, uncond = out[:, :in_channels].chunk(2)
    g = uncond + scale * (cond - uncond)
    return torch.cat([g, g])


def euler(drift, x, path, prediction, num_steps, y, state_dtype):
    """The control's sampler: Euler over the grid with the state rounded
    to `state_dtype` at each step (the precision below the port's
    float32 state)."""
    ts, dts = grid(path, prediction, num_steps)
    for t, dt in zip(ts, dts):
        tv = torch.full((x.shape[0],), t, dtype=torch.float32,
                        device=x.device)
        x = (x.to(state_dtype) + (dt * drift(x, tv, y=y)).to(state_dtype)
             ).float()
    return x
