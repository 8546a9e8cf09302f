"""What each remat policy keeps on the dispatcher's side
(`dimsum_torch/utils/remat.py`), which gradients cannot show: they are the
same whatever is kept.  On the tiny DiM of tests/test_torch_remat.py
(hidden 32, depth 2, a DiT block after the 2nd, latent 8), the ops that
reach the dispatcher during the backward are counted below every selective
context, over tests/test_remat.py's grid of policies:

  * matmuls (`aten.mm`, `addmm`, `bmm`, `baddbmm`): under a policy that
    keeps "dots" the replay's are served from the first forward, so the
    backward runs exactly as many as without remat; under any other
    policy more (full remat replays them);
  * the ops of each tagged region (`remat.tag`: the plain scan, scan_out;
    the conv, conv_out; SDPA, attn_out; the ops every selective context
    passes through, detach and sizes, left out): none under a policy that
    keeps the region, as many as under full remat under one that does
    not.

Exact counts, no tolerance.  The module imports no JAX, so that it also
runs where only PyTorch is installed (`pytest --noconftest`).
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import SAC_IGNORED_OPS

from dimsum_torch.models.dim import DiM, DiMConfig, random_init_
from dimsum_torch.utils import remat

CFG = dict(img_resolution=8, hidden_size=32, depth=2, num_classes=10,
           use_attn_every_k_layers=2, label_dropout=0.1)
POLICIES = [None, "dots", "scan", "dots_scan", "save:dots+scan_out+attn_out",
            "save:scan_out+attn_out+conv_out", "save:attn_out",
            "save:conv_out"]
MATMULS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
           torch.ops.aten.baddbmm}


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One PyTorch thread (`tests/test_torch_convert.py::torch_one_thread`,
    which this module cannot import: that module imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _BackwardOps(TorchDispatchMode):
    """Counts the ops that reach the dispatcher below the selective
    contexts: matmuls, and ops run inside each `remat.tag` region, leaving
    out those the contexts always pass through."""

    def __init__(self):
        super().__init__()
        self.dots = 0
        self.tagged = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.dots += func.overloadpacket in MATMULS
        name = getattr(remat._local, "tag", None)
        if name is not None and func not in SAC_IGNORED_OPS:
            self.tagged[name] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(**cfg):
    model = random_init_(DiM(DiMConfig(**CFG, **cfg)), 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(
        np.float32))
    loss = (model(x, torch.tensor([0.2, 0.8]), torch.tensor([0, 1])) ** 2
            ).sum()
    with _BackwardOps() as ops:
        loss.backward()
    return ops


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_keeps_what_it_names(policy):
    off = _backward_ops()
    full = _backward_ops(grad_checkpoint=True)
    got = _backward_ops(grad_checkpoint=True, remat_policy=policy)
    assert not off.tagged and full.dots > off.dots
    assert set(full.tagged) == set(remat.TAGS)
    keep = remat.parse_policy(policy)
    assert (got.dots == off.dots) == ("dots" in keep)
    assert got.dots >= off.dots
    for name in remat.TAGS:
        if name in keep:
            assert got.tagged[name] == 0, name
        else:
            assert got.tagged[name] == full.tagged[name], name
