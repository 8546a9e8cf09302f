"""Training on one device (port of `dimsum_tpu/parallel`)."""

from dimsum_torch.parallel.train import (  # noqa: F401
    TrainState,
    clip_by_global_norm,
    create_optimizer,
    create_train_state,
    ema_update,
    make_train_step,
)
