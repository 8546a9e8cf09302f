"""The port's selective-scan training pair (dimsum_torch/ops/selective_scan.py)
against the JAX package: the plain versions of kernels 2 and 3 against the
Pallas `selective_scan_fwd_train` / `selective_scan_bwd_pallas` run in
interpret mode at the same chunk, and the autograd Function on its plain
route against `jax.grad` through `selective_scan_dtlow(impl="xla")`, in both
directions.  Inputs come from a numpy seed and go to both packages.

Tolerances, fp32 throughout, relative to each tensor's largest value: the
Pallas kernels compute exp as exp2 and scan each chunk in a tree order, the
XLA route is an associative scan, the port's plain versions run the
sequential recurrence, so they agree to summation order over L <= 64:
1e-4 (measured ~1e-6..1e-5)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dimsum_tpu.ops.selective_scan import selective_scan_dtlow as jax_dtlow
from dimsum_tpu.ops.selective_scan_bwd import (selective_scan_bwd_pallas,
                                               selective_scan_fwd_train)
from dimsum_torch.ops.selective_scan import (SelectiveScanDtLowFn,
                                             selective_scan_bwd_ref,
                                             selective_scan_dtlow,
                                             selective_scan_dtlow_train,
                                             selective_scan_fwd_train_ref)
from tests.test_torch_convert import torch_one_thread  # noqa: F401

TOL = 1e-4
NAMES = ("u", "dt_low", "dt_w", "A", "B", "C", "D", "z", "bias")


def make_inputs(seed, batch=2, L=32, dim=128, n=8, rank=4):
    rng = np.random.default_rng(seed)
    f = np.float32
    dt_w = rng.standard_normal((rank, dim)) / np.sqrt(rank)
    return dict(
        u=rng.standard_normal((batch, L, dim)).astype(f),
        dt_low=(0.5 * rng.standard_normal((batch, L, rank))).astype(f),
        dt_w=dt_w.astype(f),
        A=-np.exp(0.5 * rng.standard_normal((dim, n))).astype(f),
        B=rng.standard_normal((batch, L, n)).astype(f),
        C=rng.standard_normal((batch, L, n)).astype(f),
        D=(1 + 0.1 * rng.standard_normal(dim)).astype(f),
        z=rng.standard_normal((batch, L, dim)).astype(f),
        bias=(0.1 * rng.standard_normal(dim)).astype(f))


def _t(x):
    return {k: torch.from_numpy(v.copy()) for k, v in x.items()}


def _port_args(x):
    return ([x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C")],
            dict(D=x["D"], z=x["z"], delta_bias=x["bias"],
                 delta_softplus=True))


def assert_close_scaled(got, want, tol=TOL, name=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _graph_nodes(y):
    """Names of the autograd nodes behind y."""
    seen, todo = set(), [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node.name() not in seen:
            seen.add(node.name())
            todo.extend(f for f, _ in node.next_functions)
    return seen


def _jax_fwd_train(x, chunk):
    delta = np.einsum("blr,rd->bld", x["dt_low"], x["dt_w"])
    with pltpu.force_tpu_interpret_mode():
        y, o, bnd = selective_scan_fwd_train(
            x["u"], delta, x["A"], x["B"], x["C"], x["D"], x["z"], x["bias"],
            True, chunk=chunk, d_block=128)
    return delta, np.array(y), np.array(o), np.array(bnd)


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_fwd_train_matches_pallas_interpret(chunk):
    x = make_inputs(0)
    _, y, o, bnd = _jax_fwd_train(x, chunk)
    args, kw = _port_args(_t(x))
    got = selective_scan_fwd_train_ref(*args, **kw, chunk=chunk)
    assert got[2].shape == (2, 32 // chunk, 8, 128)
    for name, a, b in zip(("y", "o", "boundaries"), got, (y, o, bnd)):
        assert a.dtype == torch.float32, name
        assert_close_scaled(a.numpy(), b, name=name)
    assert not got[2][:, 0].any()


def test_plain_bwd_matches_pallas_interpret():
    """Both backwards from the same saved o and states (the JAX forward's)
    and the same output gradient g."""
    x = make_inputs(1)
    delta, _, o, bnd = _jax_fwd_train(x, 16)
    g = np.random.default_rng(2).standard_normal(x["u"].shape).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = selective_scan_bwd_pallas(
            x["u"], delta, x["A"], x["B"], x["C"], x["D"], x["z"], x["bias"],
            True, o, bnd, jnp.asarray(g), chunk=16, d_block=128)
    args, kw = _port_args(_t(x))
    got = selective_scan_bwd_ref(*args, **kw, o=torch.from_numpy(o),
                                 boundaries=torch.from_numpy(bnd),
                                 g=torch.from_numpy(g), chunk=16)
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")
    for name, a, b in zip(names, got, want):
        assert_close_scaled(a.numpy(), np.asarray(b), name=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_function_grads_match_jax_grad(reverse):
    """The Function on its plain route (CPU tensors) against jax.grad of the
    XLA route, for every input, with a ragged last chunk (L 40)."""
    x = make_inputs(3 + reverse, L=40, dim=24)
    g = np.random.default_rng(5).standard_normal(x["u"].shape).astype(
        np.float32)

    def loss(*a):
        u, dt_low, dt_w, A, B, C, D, z, bias = a
        y = jax_dtlow(u, dt_low, dt_w, A, B, C, D, z, bias,
                      delta_softplus=True, impl="xla", reverse=reverse)
        return (y * g).sum()

    want_y = jax_dtlow(*[x[k] for k in NAMES[:6]], x["D"], x["z"],
                       x["bias"], delta_softplus=True, impl="xla",
                       reverse=reverse)
    want = jax.grad(loss, argnums=tuple(range(9)))(*[x[k] for k in NAMES])

    xt = {k: v.requires_grad_(True) for k, v in _t(x).items()}
    args, kw = _port_args(xt)
    y = selective_scan_dtlow_train(*args, **kw, reverse=reverse)
    assert "SelectiveScanDtLowFnBackward" in _graph_nodes(y)
    got = torch.autograd.grad(y, [xt[k] for k in NAMES],
                              torch.from_numpy(g))
    assert_close_scaled(y.detach().numpy(), np.asarray(want_y), name="y")
    for name, a, b in zip(NAMES, got, want):
        assert_close_scaled(a.numpy(), np.asarray(b), name="d" + name)


def test_cpu_route_is_plain_autograd_and_agrees_with_the_function():
    """On CPU tensors `selective_scan_dtlow` differentiates the plain
    recurrence with ordinary autograd (no Function); its gradients equal
    the Function's."""
    x = make_inputs(6, L=21, dim=16)
    xt = {k: v.requires_grad_(True) for k, v in _t(x).items()}
    args, kw = _port_args(xt)
    g = torch.randn(2, 21, 16, generator=torch.Generator().manual_seed(0))
    y_ref = selective_scan_dtlow(*args, **kw, reverse=True)
    assert "SelectiveScanDtLowFnBackward" not in _graph_nodes(y_ref)
    y_fn = selective_scan_dtlow_train(*args, **kw, reverse=True)
    torch.testing.assert_close(y_fn, y_ref, rtol=1e-6, atol=1e-6)
    leaves = [xt[k] for k in NAMES]
    for a, b in zip(torch.autograd.grad(y_fn, leaves, g),
                    torch.autograd.grad(y_ref, leaves, g)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_function_without_optionals():
    """No D, z or bias (None into the Function), no softplus."""
    x = _t(make_inputs(7, L=16, dim=8))
    leaves = [x[k].requires_grad_(True) for k in NAMES[:6]]
    x["dt_low"] = x["dt_low"].detach().abs().requires_grad_(True)
    leaves[1] = x["dt_low"]
    y = SelectiveScanDtLowFn.apply(*leaves, None, None, None, False)
    want = selective_scan_dtlow(*leaves, impl="ref")
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    g = torch.ones_like(y)
    for a, b in zip(torch.autograd.grad(y, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
