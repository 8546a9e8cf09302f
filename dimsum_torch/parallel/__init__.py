"""Training (one device or data-parallel), process groups and the
process-group setup (port of `dimsum_tpu/parallel`)."""

from dimsum_torch.parallel.mesh import (  # noqa: F401
    SeqGroups,
    all_gather,
    init_distributed,
    make_seq_group,
)
from dimsum_torch.parallel.train import (  # noqa: F401
    TrainState,
    clip_by_global_norm,
    create_optimizer,
    create_train_state,
    ema_update,
    make_train_step,
    warmup_cosine_schedule,
)
