"""The scan cases the Pallas kernels take beyond the model zoo's, against
the JAX package: grouped B/C (the reference's ngroups mode), N past 32 and
a full delta under a gradient.  The port's `selective_scan` front end (its
plain route, and its two autograd Functions over their plain versions, the
routes its CUDA tensors take around the kernels) against the JAX
`selective_scan(impl="pallas")` in interpret mode and `jax.grad` of it;
against the JAX XLA route at N 40; `selective_scan_dtlow` with a 4-D B
against the JAX one; kernels 2 and 3's plain versions at N 64 and on a
full delta against the Pallas `selective_scan_fwd_train` /
`selective_scan_bwd_pallas` in interpret mode.  Inputs from numpy seeds,
fp32, batch 1 or 2, L 16 or 32.

Tolerance 1e-4 of each tensor's largest value, as
tests/test_torch_scan_train.py (exp2 against exp, summation order)."""

import functools

import numpy as np
import pytest
import torch
import jax
from jax.experimental.pallas import tpu as pltpu

from dimsum_tpu.ops.selective_scan import selective_scan as jax_scan
from dimsum_tpu.ops.selective_scan import selective_scan_dtlow as jax_dtlow
from dimsum_tpu.ops.selective_scan_bwd import (selective_scan_bwd_pallas,
                                               selective_scan_fwd_train)
from dimsum_torch.ops.selective_scan import (SelectiveScanFn,
                                             SelectiveScanGroupedFn,
                                             selective_scan,
                                             selective_scan_bwd_ref,
                                             selective_scan_dtlow,
                                             selective_scan_fwd_train_ref)
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_scan_train import assert_close_scaled, make_inputs

KEYS = ("u", "delta", "A", "B", "C", "D", "z", "bias")


def delta_inputs(seed, dim=128, n=16, groups=None, L=16, batch=1):
    """make_inputs with the full delta = dt_low @ dt_w (fp32) and, with
    `groups`, B and C of (batch, L, groups, n)."""
    x = make_inputs(seed, batch=batch, L=L, dim=dim, n=n, rank=8)
    x["delta"] = np.einsum("blr,rd->bld", x.pop("dt_low"), x.pop("dt_w"))
    if groups:
        rng = np.random.default_rng(seed + 1)
        for k in ("B", "C"):
            x[k] = rng.standard_normal(
                (batch, L, groups, n)).astype(np.float32)
    return x


def _jax_y_and_grads(x, g, impl):
    """The JAX front end's y and its gradient in every input of KEYS."""
    args = [x[k] for k in KEYS]
    y = jax_scan(*args, delta_softplus=True, impl=impl)

    def loss(*a):
        return (jax_scan(*a, delta_softplus=True, impl=impl) * g).sum()

    return [np.asarray(y)] + [np.asarray(v) for v in jax.grad(
        loss, argnums=tuple(range(len(KEYS))))(*args)]


def _port_y_and_grads(x, g, route):
    """The port's y and gradients through `route`: "front" (the front end,
    which takes its plain route for CPU tensors) or "function" (the
    Function the front end takes for CUDA tensors, over its plain
    versions here)."""
    leaves = [torch.from_numpy(x[k].copy()).requires_grad_(True)
              for k in KEYS]
    if route == "front":
        y = selective_scan(*leaves, delta_softplus=True)
    elif x["B"].ndim == 4:
        y = SelectiveScanGroupedFn.apply(*leaves, True)
    else:
        y = SelectiveScanFn.apply(*leaves, True)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    return [y.detach()] + list(grads)


CASES = {"grouped-g2": dict(dim=256, n=8, groups=2),
         "n64": dict(dim=128, n=64),
         "full-delta": dict(dim=128, n=16)}


@functools.lru_cache(maxsize=None)
def _pallas_case(case):
    """A case's inputs, cotangent and the Pallas route's y and gradients,
    computed once for both of the port's routes."""
    x = delta_inputs(40 + sorted(CASES).index(case), **CASES[case])
    g = np.random.default_rng(7).standard_normal(
        x["u"].shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        return x, g, _jax_y_and_grads(x, g, "pallas")


@pytest.mark.parametrize("route", ["front", "function"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_front_end_matches_pallas_and_its_grad(case, route):
    x, g, want = _pallas_case(case)
    got = _port_y_and_grads(x, g, route)
    for name, a, b in zip(("y",) + tuple("d" + k for k in KEYS), got, want):
        assert_close_scaled(a.numpy(), b, name=name)


@pytest.mark.parametrize("groups", [None, 4])
def test_front_end_matches_xla_at_n40(groups):
    """N 40 (two of the kernels' 32-state tiles, the second ragged), with
    and without groups, against the XLA route: y, the last state, and
    every gradient through the Function and the plain route."""
    x = delta_inputs(50, dim=64, n=40, groups=groups, batch=2)
    args = [x[k] for k in KEYS]
    y, last = jax_scan(*args, delta_softplus=True, return_last_state=True,
                       impl="xla")
    got_y, got_last = selective_scan(
        *[torch.from_numpy(a.copy()) for a in args], delta_softplus=True,
        return_last_state=True)
    assert_close_scaled(got_y.numpy(), np.asarray(y), name="y")
    assert_close_scaled(got_last.numpy(), np.asarray(last), name="last")
    g = np.random.default_rng(8).standard_normal(
        x["u"].shape).astype(np.float32)
    want = _jax_y_and_grads(x, g, "xla")
    for route in ("front", "function"):
        got = _port_y_and_grads(x, g, route)
        for name, a, b in zip(("y",) + tuple("d" + k for k in KEYS), got,
                              want):
            assert_close_scaled(a.numpy(), b, name=f"{route} {name}")


@pytest.mark.parametrize("reverse", [False, True])
def test_dtlow_with_grouped_b_matches_jax(reverse):
    """A 4-D B through `selective_scan_dtlow`: the JAX function expands
    delta and takes its grouped route (Pallas, interpret mode)."""
    x = make_inputs(60, L=32, dim=256, n=8, rank=8)
    rng = np.random.default_rng(61)
    for k in ("B", "C"):
        x[k] = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    names = ("u", "dt_low", "dt_w", "A", "B", "C", "D", "z", "bias")
    with pltpu.force_tpu_interpret_mode():
        want = jax_dtlow(*[x[k] for k in names], delta_softplus=True,
                         impl="pallas", reverse=reverse)
    t = {k: torch.from_numpy(x[k].copy()) for k in names}
    got = selective_scan_dtlow(*[t[k] for k in names[:7]], z=t["z"],
                               delta_bias=t["bias"], delta_softplus=True,
                               reverse=reverse)
    assert_close_scaled(got.numpy(), np.asarray(want), name="y")


@pytest.mark.parametrize("full_delta", [False, True])
def test_plain_training_pair_matches_pallas(full_delta):
    """Kernel 2's and kernel 3's plain versions against the Pallas training
    kernels in interpret mode: at N 64 from dt_low (the split entries'
    function) and at N 16 on a full delta (the delta entries': dt_w
    None)."""
    n = 16 if full_delta else 64
    x = make_inputs(70 + n, L=32, dim=128, n=n, rank=8)
    delta = np.einsum("blr,rd->bld", x["dt_low"], x["dt_w"])
    jax_args = (x["u"], delta, x["A"], x["B"], x["C"], x["D"], x["z"],
                x["bias"], True)
    with pltpu.force_tpu_interpret_mode():
        y, o, bnd = selective_scan_fwd_train(*jax_args, chunk=16,
                                             d_block=128)
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    dt = ((torch.from_numpy(delta), None) if full_delta
          else (t["dt_low"], t["dt_w"]))
    args = (t["u"], *dt, t["A"], t["B"], t["C"])
    kw = dict(D=t["D"], z=t["z"], delta_bias=t["bias"], delta_softplus=True)
    got = selective_scan_fwd_train_ref(*args, **kw)
    for name, a, b in zip(("y", "o", "boundaries"), got, (y, o, bnd)):
        assert_close_scaled(a.numpy(), np.asarray(b), name=name)
    g = np.random.default_rng(n).standard_normal(
        x["u"].shape).astype(np.float32)
    o, bnd = np.array(o), np.array(bnd)
    with pltpu.force_tpu_interpret_mode():
        want = selective_scan_bwd_pallas(*jax_args, o, bnd, g, chunk=16,
                                         d_block=128)
    got = selective_scan_bwd_ref(*args, **kw, o=torch.from_numpy(o),
                                 boundaries=torch.from_numpy(bnd),
                                 g=torch.from_numpy(g))
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")
    for name, a, b in zip(names, got, want):
        assert_close_scaled(a.numpy(), np.asarray(b), name=name)
