"""Flow-matching transport for training and sampling (port of
`dimsum_tpu/transport`)."""

from __future__ import annotations

from dimsum_torch.transport.path import (GVPCPlan, ICPlan,  # noqa: F401
                                         VPCPlan, expand_t_like_x)
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
    on the VP path 1e-5 (train) and 1e-3 (sample); on the Linear and GVP
    paths 1e-3 for noise or score prediction and 0 for velocity.
    `path_args` go to the plan (the VP plan's sigma_min, sigma_max)."""
    path_args = path_args or {}
    model_type = {"noise": ModelType.NOISE, "score": ModelType.SCORE}.get(
        prediction, ModelType.VELOCITY)
    loss_type = {"velocity": WeightType.VELOCITY,
                 "likelihood": WeightType.LIKELIHOOD}.get(
        loss_weight, WeightType.NONE)
    ptype, plan_cls = {"Linear": (PathType.LINEAR, ICPlan),
                       "GVP": (PathType.GVP, GVPCPlan),
                       "VP": (PathType.VP, VPCPlan)}[path_type]

    if ptype == PathType.VP:
        eps_train, eps_sample = 1e-5, 1e-3
    elif model_type != ModelType.VELOCITY:
        eps_train = eps_sample = 1e-3
    else:
        eps_train = eps_sample = 0.0
    train_eps = eps_train if train_eps is None else train_eps
    sample_eps = eps_sample if sample_eps is None else sample_eps
    return Transport(model_type=model_type, path_type=ptype,
                     loss_type=loss_type, train_eps=train_eps,
                     sample_eps=sample_eps, path_sampler=plan_cls(**path_args),
                     t_sample_mode=t_sample_mode)
