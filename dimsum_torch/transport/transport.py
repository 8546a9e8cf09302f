"""Transport (flow matching) for sampling, port of
`dimsum_tpu/transport/transport.py`: the time interval, the velocity
model's probability-flow ODE drift, and `Sampler.sample_ode` with Euler and
Heun.  The noise and score drifts, training losses, SDE sampling,
likelihoods and dopri5 are not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

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


@dataclasses.dataclass(frozen=True)
class Transport:
    model_type: ModelType
    path_type: PathType
    loss_type: WeightType
    train_eps: float
    sample_eps: float
    path_sampler: Any = None

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
