"""The port's plain dt_low scan and training pair at the ranks above 64
that the CUDA kernels now take (DiM-XL/2's linear mixers: r 72; mamba-2.8b:
r 160), against the JAX package: the inference scan against the Pallas
`selective_scan_dtlow` in interpret mode (both directions), kernel 2's and
kernel 3's plain versions against the Pallas `selective_scan_fwd_train` /
`selective_scan_bwd_pallas` in interpret mode, and the autograd Function
on its plain route against `jax.grad` of the XLA route.  Inputs from a
numpy seed, fp32, dim 128, L 40 (a ragged 16-step chunk; 48 against the
Pallas training kernels, which take whole chunks).

Tolerance 1e-4 of each tensor's largest value, as
tests/test_torch_scan_train.py (summation order over L and r)."""

import numpy as np
import pytest
import torch
import jax
from jax.experimental.pallas import tpu as pltpu

from dimsum_tpu.ops.selective_scan import selective_scan_dtlow as jax_dtlow
from dimsum_tpu.ops.selective_scan_bwd import selective_scan_bwd_pallas
from dimsum_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                             selective_scan_dtlow,
                                             selective_scan_dtlow_train,
                                             selective_scan_fwd_train_ref)
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_scan_train import (NAMES, _jax_fwd_train, _port_args,
                                         _t, assert_close_scaled,
                                         make_inputs)

RANKS = [72, 160]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rank", RANKS)
def test_plain_scan_matches_pallas_at_high_rank(rank, reverse):
    x = make_inputs(10 + rank, L=40, n=16, rank=rank)
    with pltpu.force_tpu_interpret_mode():
        want = jax_dtlow(*[x[k] for k in NAMES[:6]], x["D"], x["z"],
                         x["bias"], delta_softplus=True, impl="pallas",
                         reverse=reverse)
    args, kw = _port_args(_t(x))
    got = selective_scan_dtlow(*args, **kw, reverse=reverse, impl="ref")
    assert_close_scaled(got.numpy(), np.asarray(want), name="y")


@pytest.mark.parametrize("rank", RANKS)
def test_plain_training_pair_matches_pallas_at_high_rank(rank):
    """Kernel 2's plain version against the Pallas training forward (y, o,
    the chunk-start states), then kernel 3's against the Pallas backward
    from the JAX forward's o and states."""
    x = make_inputs(20 + rank, L=48, n=16, rank=rank)
    delta, y, o, bnd = _jax_fwd_train(x, 16)
    args, kw = _port_args(_t(x))
    got = selective_scan_fwd_train_ref(*args, **kw)
    for name, a, b in zip(("y", "o", "boundaries"), got, (y, o, bnd)):
        assert_close_scaled(a.numpy(), b, name=name)
    g = np.random.default_rng(rank).standard_normal(x["u"].shape).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = selective_scan_bwd_pallas(
            x["u"], delta, x["A"], x["B"], x["C"], x["D"], x["z"], x["bias"],
            True, o, bnd, g, chunk=16, d_block=128)
    got = selective_scan_bwd_ref(*args, **kw, o=torch.from_numpy(o),
                                 boundaries=torch.from_numpy(bnd),
                                 g=torch.from_numpy(g))
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")
    for name, a, b in zip(names, got, want):
        assert_close_scaled(a.numpy(), np.asarray(b), name=name)


@pytest.mark.parametrize("rank", RANKS)
def test_function_grads_match_jax_grad_at_high_rank(rank):
    x = make_inputs(30 + rank, L=40, dim=24, n=16, rank=rank)
    g = np.random.default_rng(rank + 1).standard_normal(
        x["u"].shape).astype(np.float32)

    def loss(*a):
        u, dt_low, dt_w, A, B, C, D, z, bias = a
        return (jax_dtlow(u, dt_low, dt_w, A, B, C, D, z, bias,
                          delta_softplus=True, impl="xla") * g).sum()

    want = jax.grad(loss, argnums=tuple(range(9)))(*[x[k] for k in NAMES])
    xt = {k: v.requires_grad_(True) for k, v in _t(x).items()}
    args, kw = _port_args(xt)
    y = selective_scan_dtlow_train(*args, **kw)
    got = torch.autograd.grad(y, [xt[k] for k in NAMES], torch.from_numpy(g))
    for name, a, b in zip(NAMES, got, want):
        assert_close_scaled(a.numpy(), np.asarray(b), name="d" + name)
