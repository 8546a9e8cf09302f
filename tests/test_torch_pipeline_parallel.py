"""The port's GPipe pipeline parallelism (`parallel/pipeline.py`) against
the JAX package on the CPU: `dim_pipeline_forward` over 2 stage ranks at 1,
2 and 4 microbatches (each a different schedule: 2, 3 and 5 steps, the
bubble with it).

The ranks are 2 spawned processes joined by gloo over a `file://` store
(the helpers of tests/test_torch_tensor_parallel.py, which, like this
module, imports no JAX at its top: every rank imports it).  The JAX side
runs in the test's own process: its sequential model, and its
`dim_pipeline_forward` on a 2-device stage mesh at 2 microbatches (one
compile of the shard_map pipeline; JAX holds its pipeline to its
sequential model at every count itself, tests/test_pipeline.py).

Tolerance, fp32: 1e-5 of the output's scale against both (the JAX pipeline
is exact against its sequential model; the port's blocks against JAX's
are ~1e-6 apart)."""

import numpy as np
import torch
import torch.distributed as dist

from dimsum_torch.models.dim import DiM, DiMConfig
from tests.test_torch_tensor_parallel import (  # noqa: F401
    K, TINY, _forward_inputs, _save_full, _scaled, _spawn, _t,
    torch_one_thread)

# tests/test_pipeline.py's configuration for the full-model pipeline:
# 8 blocks (two stages of 4), a DiT block after every 4th
PP_CFG = dict(TINY, depth=8, use_attn_every_k_layers=4, label_dropout=0.1)
COUNTS = (1, 2, 4)


def _pp_rank(r, k, path):
    from dimsum_torch.parallel.pipeline import (dim_pipeline_forward,
                                                keep_stage_blocks_)

    inp = dict(np.load(path / "inputs.npz"))
    model = DiM(DiMConfig(**PP_CFG))
    model.load_state_dict(torch.load(path / "full.pt"), strict=True)
    keep_stage_blocks_(model.eval(), dist.group.WORLD)
    assert sum(not isinstance(b, torch.nn.Identity)
               for b in model.blocks) == 4
    for m in COUNTS:
        with torch.no_grad():
            out = dim_pipeline_forward(model, _t(inp["x"]), _t(inp["t"]),
                                       _t(inp["y"]).long(), dist.group.WORLD,
                                       num_microbatches=m)
        np.save(path / f"out{r}_{m}.npy", out.numpy())



def test_pp_matches_jax_pipeline(tmp_path):
    """The port's pipeline over 2 stage ranks at 1, 2 and 4 microbatches
    against the JAX sequential model, and at 2 against the JAX
    `dim_pipeline_forward` on a 2-device stage mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dimsum_tpu.models.dim import DiM as JaxDiM, DiMConfig as JaxCfg
    from dimsum_tpu.parallel.pipeline import dim_pipeline_forward
    from tests.test_torch_convert import randomize

    jcfg = JaxCfg(**PP_CFG, scan_impl="xla")
    model = JaxDiM(jcfg)
    params = randomize(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1,), jnp.int32)), 11)
    params = jax.tree.map(jnp.asarray, params)
    inp = _forward_inputs(tmp_path)
    inp = {k: np.concatenate([v, v[:1]]) for k, v in inp.items()}  # N 4
    np.savez(tmp_path / "inputs.npz", **inp)
    _save_full(tmp_path, params)
    x, t, y = (jnp.asarray(inp[k]) for k in ("x", "t", "y"))
    seq = np.asarray(model.apply(params, x, t, y))
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("stage",))
    _spawn(_pp_rank, tmp_path, tmp_path)
    jax_pp = np.asarray(dim_pipeline_forward(jcfg, params["params"], x, t,
                                             y, mesh, num_microbatches=2))
    _scaled(jax_pp, seq, 1e-6, "jax pipeline")
    for m in COUNTS:
        outs = [np.load(tmp_path / f"out{r}_{m}.npy") for r in range(K)]
        np.testing.assert_array_equal(outs[0], outs[1])
        _scaled(outs[0], seq, 1e-5, f"pipeline m={m}")
        if m == 2:
            _scaled(outs[0], jax_pp, 1e-5, "pipeline m=2 against JAX's")
