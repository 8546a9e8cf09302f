"""Training (one device, data- and tensor-parallel), process groups and
the process-group setup, expert and pipeline parallelism (port of
`dimsum_tpu/parallel`)."""

from dimsum_torch.parallel.mesh import (  # noqa: F401
    MeshGroups,
    SeqGroups,
    all_gather,
    gather_state_dict,
    init_distributed,
    make_mesh_groups,
    make_seq_group,
    shard_state_dict,
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
