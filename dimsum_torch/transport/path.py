"""Coupling plans (interpolants), port of `dimsum_tpu/transport/path.py`:
alpha_t multiplies the data, sigma_t the noise, and time runs noise (t=0)
-> data (t=1).  Sampling a velocity model needs only the plan's type (for
the time interval); the schedules are kept as the plans' definition.  The
VP plan and the DCT-blurred interpolant are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ICPlan:
    """Linear coupling: alpha_t = t, sigma_t = 1 - t.  Each method returns
    (value, d/dt value)."""

    def compute_alpha_t(self, t):
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t):
        return 1 - t, -torch.ones_like(t)


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
