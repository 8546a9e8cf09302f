"""A rank of tests/test_torch_extras.py's 2-process collector test, kept in
a module that imports neither JAX nor the JAX package, so each spawned
rank starts quickly."""

import datetime
import json

import numpy as np
import torch
import torch.distributed as dist

from dimsum_torch.utils import training_stats as ts


def stats_rank(r, k, port, out):
    """Rank r of k: reports its own loss values and, through report0, one
    lr; writes the collector's (num, mean, std) a name after update()."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=k, rank=r,
                            timeout=datetime.timedelta(seconds=60))
    try:
        ts.reset()
        c = ts.Collector()
        ts.report("loss", np.arange(3 * r, 3 * r + 3, dtype=np.float64))
        ts.report0("lr", [0.5])
        c.update()
        with open(f"{out}/rank{r}.json", "w") as f:
            json.dump({n: [c.num(n), c.mean(n), c.std(n)] for n in c.names()},
                      f)
    finally:
        dist.destroy_process_group()
