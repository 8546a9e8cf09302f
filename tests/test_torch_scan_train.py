"""The port's selective-scan training pair (dimsum_torch/ops/selective_scan.py)
against the JAX package: the plain versions of kernels 2 and 3 against the
Pallas `selective_scan_fwd_train` / `selective_scan_bwd_pallas` run in
interpret mode at the same chunk, and the autograd Function on its plain
route against `jax.grad` through `selective_scan_dtlow(impl="xla")`, in both
directions.  Inputs come from a numpy seed and go to both packages.  The
kernels' chunk-parallel decompositions in plain PyTorch (kernel 2: the state
pass, then every chunk from its state; kernel 3: the carry pass, then every
chunk from its carry) are held to the sequential walks, ragged L included,
and to the Pallas kernels.

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
from dimsum_torch.ops.selective_scan import (
    SelectiveScanDtLowFn, _bwd, selective_scan_bwd_carry_ref,
    selective_scan_bwd_core_ref, selective_scan_bwd_ref, selective_scan_dtlow,
    selective_scan_dtlow_train, selective_scan_fwd_train_ref,
    selective_scan_fwd_train_states_ref)
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


def _states(args, kw):
    """The state pass's boundaries for the forward's arguments."""
    return selective_scan_fwd_train_states_ref(
        *args[:5], delta_bias=kw.get("delta_bias"),
        delta_softplus=kw["delta_softplus"])


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


@pytest.mark.parametrize("L", [32, 64])
def test_chunk_parallel_fwd_train_matches_pallas_interpret(L):
    """Kernel 2's decomposition in plain PyTorch (the state pass, then every
    chunk seeded with its state) against the Pallas forward in interpret
    mode: y, o and the boundaries."""
    x = make_inputs(50 + L, L=L)
    _, y, o, bnd = _jax_fwd_train(x, 16)
    args, kw = _port_args(_t(x))
    states = _states(args, kw)
    assert_close_scaled(states.numpy(), bnd, name="states")
    got = selective_scan_fwd_train_ref(*args, **kw, boundaries=states)
    for name, a, b in zip(("y", "o", "boundaries"), got, (y, o, bnd)):
        assert_close_scaled(a.numpy(), b, name=name)


# fp32 tolerance of the chunk-parallel decomposition against the sequential
# walk: the same products, chained per chunk (measured <= 1.2e-7)
SEQ_TOL = 1e-5
FWD_SHAPES = [(8, 5), (16, 32), (32, 64)]  # (N, r)


def _fwd_case(L, n, r, optionals):
    """Inputs at (L, N, r), dim 24, with z / D / bias or without them."""
    x = make_inputs(40 + L + n + r, L=L, dim=24, n=n, rank=r)
    args, kw = _port_args(_t(x))
    if not optionals:
        kw = dict(delta_softplus=True)
    return args, kw


@pytest.mark.parametrize("n, r", FWD_SHAPES)
@pytest.mark.parametrize("L", [1, 15, 16, 17, 48, 300])
def test_states_ref_matches_sequential_states(L, n, r):
    """The state pass (alpha and beta of every chunk in parallel, then the
    chain from the left) against the states the sequential walk saves at
    every chunk start, ragged L included."""
    args, kw = _fwd_case(L, n, r, True)
    want = selective_scan_fwd_train_ref(*args, **kw)[2]
    got = _states(args, kw)
    assert got.shape == (2, -(-L // 16), n, 24)
    assert not got[:, 0].any()
    assert_close_scaled(got.numpy(), want.numpy(), SEQ_TOL, "boundaries")


@pytest.mark.parametrize("optionals", [True, False])
@pytest.mark.parametrize("n, r", FWD_SHAPES)
@pytest.mark.parametrize("L", [1, 15, 16, 17, 48, 300])
def test_chunk_seeded_fwd_train_matches_sequential(L, n, r, optionals):
    """Every chunk run from the state pass's boundaries gives what the
    sequential walk gives: y, o and the boundaries, with and without z, D
    and bias."""
    args, kw = _fwd_case(L, n, r, optionals)
    want = selective_scan_fwd_train_ref(*args, **kw)
    states = _states(args, kw)
    got = selective_scan_fwd_train_ref(*args, **kw, boundaries=states)
    assert got[2] is not None and torch.equal(got[2], states)
    for name, a, b in zip(("y", "o", "boundaries"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert_close_scaled(a.numpy(), b.numpy(), SEQ_TOL, name)


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


def _core_args(x, go, bnd):
    """The reverse-scan core's arguments from numpy inputs."""
    t = _t(x)
    return ([t[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C")]
            + [t["bias"], True, torch.from_numpy(go), torch.from_numpy(bnd)])


def _chunk_parallel_core(u, dt_low, dt_w, A, B, C, delta_bias,
                         delta_softplus, go, boundaries):
    """Kernel 3's decomposition in plain PyTorch: the carry pass, then every
    chunk seeded with its own carry."""
    w = selective_scan_bwd_carry_ref(dt_low, dt_w, A, C, delta_bias,
                                     delta_softplus, go)
    return selective_scan_bwd_core_ref(u, dt_low, dt_w, A, B, C, delta_bias,
                                       delta_softplus, go, boundaries,
                                       carries=w)


def _fwd_train_states(x, L):
    """go and the chunk-start states of the port's plain forward at L."""
    args, kw = _port_args(_t(x))
    _, _, bnd = selective_scan_fwd_train_ref(*args, **kw)
    go = np.random.default_rng(L).standard_normal(x["u"].shape).astype(
        np.float32)
    return go, bnd.numpy()


@pytest.mark.parametrize("L", [1, 15, 16, 17, 40, 64, 71])
def test_carry_ref_matches_sequential_carry_at_every_chunk(L):
    """The carry pass (alpha and beta of every chunk in parallel, then the
    chain from the right) against the carry the sequential reverse walk
    brings into each chunk, ragged L included."""
    x = make_inputs(10 + L, L=L, dim=24)
    go, bnd = _fwd_train_states(x, L)
    args = _core_args(x, go, bnd)
    want = selective_scan_bwd_core_ref(*args, return_carries=True)[5]
    got = selective_scan_bwd_carry_ref(*args[1:4], args[5], args[6], True,
                                       args[8])
    assert got.shape == (2, -(-L // 16), 8, 24)
    assert not got[:, -1].any()
    assert_close_scaled(got.numpy(), want.numpy(), name="w")


@pytest.mark.parametrize("L", [1, 16, 17, 40, 71])
def test_chunk_parallel_bwd_matches_sequential(L):
    """Each chunk seeded with its carry from the carry pass gives what the
    sequential walk gives: du, ddelta, dA, dB and dC."""
    x = make_inputs(20 + L, L=L, dim=24)
    go, bnd = _fwd_train_states(x, L)
    args = _core_args(x, go, bnd)
    want = selective_scan_bwd_core_ref(*args)
    got = _chunk_parallel_core(*args)
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC"), got, want):
        assert_close_scaled(a.numpy(), b.numpy(), name=name)


@pytest.mark.parametrize("L", [32, 64])
def test_chunk_parallel_bwd_matches_pallas_interpret(L):
    """The chunk-parallel decomposition inside the whole backward (gate,
    skip and bias gradients around it) against the Pallas backward in
    interpret mode, from the JAX forward's o and states."""
    x = make_inputs(30 + L, L=L)
    delta, _, o, bnd = _jax_fwd_train(x, 16)
    g = np.random.default_rng(31).standard_normal(x["u"].shape).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = selective_scan_bwd_pallas(
            x["u"], delta, x["A"], x["B"], x["C"], x["D"], x["z"], x["bias"],
            True, o, bnd, jnp.asarray(g), chunk=16, d_block=128)
    args, kw = _port_args(_t(x))
    got = _bwd(_chunk_parallel_core, *args, kw["D"], kw["z"],
               kw["delta_bias"], True, torch.from_numpy(o),
               torch.from_numpy(bnd), torch.from_numpy(g))
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


def test_profiler_classes_count_both_passes_of_each_training_kernel():
    """`profile_forward` sums kernel 2's state and main passes into one
    class, as it does kernel 3's carry and main passes."""
    from dimsum_torch.profile_forward import kernel_class

    for name, cls in (
            ("scan_fwd_train_states_kernel<__nv_bfloat16, 16, 32>",
             "selective_scan_fwd_train"),
            ("scan_fwd_train_kernel<__nv_bfloat16, 16>",
             "selective_scan_fwd_train"),
            ("scan_bwd_carry_kernel<__nv_bfloat16, 16, 32>",
             "selective_scan_bwd"),
            ("scan_bwd_kernel<float, 16, 32>", "selective_scan_bwd"),
            ("scan_fwd_kernel<__nv_bfloat16, 16, 32>", "selective_scan")):
        assert kernel_class(f"void (anonymous namespace)::{name}(...)") \
            == cls, name
