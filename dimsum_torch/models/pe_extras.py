"""Position-encoding extras, port of `dimsum_tpu/models/pe_extras.py`: the
EVA-02 2-D axial rotary tables (`vision_rotary_freqs`,
`rotate_half_interleaved`, `apply_vision_rotary`) and the plain 1-D
sin-cos table (`sinusoidal_pos_embed_1d`).  No DiM configuration uses
them; they complete the position-encoding inventory beside the ape, rope
and cpe of `models/embedders.py`."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dimsum_torch.models.embedders import rotate_half

# the interleaved rotate-half of the 2-D rotary, (x0, x1, ...) -> (-x1, x0,
# ...), under its reference name
rotate_half_interleaved = rotate_half


def vision_rotary_freqs(dim: int, pt_seq_len: int = 16,
                        ft_seq_len: Optional[int] = None,
                        theta: float = 10000.0):
    """(freqs_cos, freqs_sin), each (ft_seq_len**2, dim) float32: dim // 2
    frequencies for each grid axis, each repeated twice, the rows' axis
    first."""
    ft_seq_len = pt_seq_len if ft_seq_len is None else ft_seq_len
    half = dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float64) / half))
    t = np.arange(ft_seq_len, dtype=np.float64) / ft_seq_len * pt_seq_len
    f = np.repeat(np.einsum("i,j->ij", t, freqs), 2, axis=-1)  # (L, half)
    fy = np.broadcast_to(f[:, None, :], (ft_seq_len, ft_seq_len, half))
    fx = np.broadcast_to(f[None, :, :], (ft_seq_len, ft_seq_len, half))
    full = np.concatenate([fy, fx], axis=-1).reshape(-1, 2 * half)
    return (torch.tensor(np.cos(full), dtype=torch.float32),
            torch.tensor(np.sin(full), dtype=torch.float32))


def apply_vision_rotary(x, freqs_cos, freqs_sin):
    """x: (..., L, dim) with the tables of `vision_rotary_freqs`."""
    return x * freqs_cos + rotate_half_interleaved(x) * freqs_sin


def sinusoidal_pos_embed_1d(num_positions: int, dim: int,
                            max_period: float = 10000.0):
    """(num_positions, dim) float32: sin at the even and cos at the odd
    channels."""
    pos = np.arange(num_positions, dtype=np.float64)[:, None]
    idx = np.arange(dim // 2, dtype=np.float64)[None, :]
    angle = pos / np.power(max_period, 2 * idx / dim)
    out = np.zeros((num_positions, dim), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.tensor(out)
