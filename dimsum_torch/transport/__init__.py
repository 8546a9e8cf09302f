"""Flow-matching transport for training and sampling (port of
`dimsum_tpu/transport`)."""

from __future__ import annotations

from dimsum_torch.transport.path import GVPCPlan, ICPlan  # noqa: F401
from dimsum_torch.transport.transport import (  # noqa: F401
    ModelType,
    PathType,
    Sampler,
    Transport,
    WeightType,
    mean_flat,
)


def create_transport(path_type: str = "Linear", prediction: str = "velocity",
                     loss_weight=None, train_eps=None, sample_eps=None,
                     path_args=None, t_sample_mode: str = "uniform"
                     ) -> Transport:
    """As the JAX `create_transport`, with the reference's eps defaults:
    1e-3 for noise or score prediction, 0 for velocity.  The "VP" path is
    not ported yet."""
    path_args = path_args or {}
    model_type = {"noise": ModelType.NOISE, "score": ModelType.SCORE}.get(
        prediction, ModelType.VELOCITY)
    loss_type = {"velocity": WeightType.VELOCITY,
                 "likelihood": WeightType.LIKELIHOOD}.get(
        loss_weight, WeightType.NONE)
    plans = {"Linear": (PathType.LINEAR, ICPlan),
             "GVP": (PathType.GVP, GVPCPlan)}
    if path_type not in plans:
        raise NotImplementedError(f"path_type {path_type!r} is not ported")
    ptype, plan_cls = plans[path_type]

    eps = 1e-3 if model_type != ModelType.VELOCITY else 0.0
    train_eps = eps if train_eps is None else train_eps
    sample_eps = eps if sample_eps is None else sample_eps
    return Transport(model_type=model_type, path_type=ptype,
                     loss_type=loss_type, train_eps=train_eps,
                     sample_eps=sample_eps, path_sampler=plan_cls(**path_args),
                     t_sample_mode=t_sample_mode)
