"""The port's selective scan (dimsum_torch/ops/selective_scan.py) against the
JAX package's: its plain recurrence, its XLA route with the dt_proj
expansion (both directions, D a multiple of 128 and not), and the Pallas
kernel the CUDA kernel ports, run in interpret mode.  Inputs come from a
numpy seed and go to both packages.

Tolerances: fp32 throughout.  The plain recurrences agree to summation
order (1e-5); the XLA route is an associative scan and the Pallas kernel
computes exp as exp2 and scans in a tree order, so they differ from the
sequential recurrence at the 1e-5..1e-4 level over L <= 256 (2e-4)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dimsum_tpu.ops.selective_scan import selective_scan_dtlow as jax_dtlow
from dimsum_tpu.ops.selective_scan import selective_scan_ref as jax_ref
from dimsum_torch.ops.selective_scan import (selective_scan_dtlow,
                                             selective_scan_ref)


def make_inputs(rng, batch=2, L=64, dim=16, n=8, rank=4, grouped=0):
    u = rng.standard_normal((batch, L, dim)).astype(np.float32)
    dt_low = (0.5 * rng.standard_normal((batch, L, rank))).astype(np.float32)
    dt_w = (rng.standard_normal((rank, dim)) / np.sqrt(rank)).astype(
        np.float32)
    A = -np.exp(0.5 * rng.standard_normal((dim, n))).astype(np.float32)
    bc_shape = (batch, L, grouped, n) if grouped else (batch, L, n)
    B = rng.standard_normal(bc_shape).astype(np.float32)
    C = rng.standard_normal(bc_shape).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    z = rng.standard_normal((batch, L, dim)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    return dict(u=u, dt_low=dt_low, dt_w=dt_w, A=A, B=B, C=C, D=D, z=z,
                bias=bias)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("L", [8, 130])
@pytest.mark.parametrize("with_dz", [True, False])
@pytest.mark.parametrize("groups", [0, 2])
def test_ref_matches_jax_ref(L, with_dz, groups):
    x = make_inputs(np.random.default_rng(L), L=L, grouped=groups)
    delta = np.einsum("blr,rd->bld", x["dt_low"], x["dt_w"])
    D, z = (x["D"], x["z"]) if with_dz else (None, None)
    want, want_h = jax_ref(
        x["u"], delta, x["A"], x["B"], x["C"], D, z, x["bias"],
        delta_softplus=True, return_last_state=True)
    got, got_h = selective_scan_ref(
        _t(x["u"]), _t(delta), _t(x["A"]), _t(x["B"]), _t(x["C"]), _t(D),
        _t(z), _t(x["bias"]), delta_softplus=True, return_last_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dim", [128, 200])
def test_dtlow_matches_jax_xla(reverse, dim):
    x = make_inputs(np.random.default_rng(dim + reverse), batch=2, L=256,
                    dim=dim, n=16, rank=8)
    want = jax_dtlow(
        x["u"], x["dt_low"], x["dt_w"], x["A"], x["B"], x["C"], x["D"],
        z=x["z"], delta_bias=x["bias"], delta_softplus=True, impl="xla",
        reverse=reverse)
    got = selective_scan_dtlow(
        _t(x["u"]), _t(x["dt_low"]), _t(x["dt_w"]), _t(x["A"]), _t(x["B"]),
        _t(x["C"]), _t(x["D"]), z=_t(x["z"]), delta_bias=_t(x["bias"]),
        delta_softplus=True, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_dtlow_matches_pallas_kernel_interpret():
    """The Pallas kernel the CUDA kernel ports (`_scan_body` with the
    in-kernel dt expansion), in interpret mode, at L 64, dim 128, N 8."""
    from jax.experimental.pallas import tpu as pltpu

    x = make_inputs(np.random.default_rng(3), batch=2, L=64, dim=128, n=8)
    with pltpu.force_tpu_interpret_mode():
        want = jax_dtlow(
            jnp.asarray(x["u"]), jnp.asarray(x["dt_low"]),
            jnp.asarray(x["dt_w"]), jnp.asarray(x["A"]),
            jnp.asarray(x["B"]), jnp.asarray(x["C"]), jnp.asarray(x["D"]),
            z=jnp.asarray(x["z"]), delta_bias=jnp.asarray(x["bias"]),
            delta_softplus=True, impl="pallas")
    got = selective_scan_dtlow(
        _t(x["u"]), _t(x["dt_low"]), _t(x["dt_w"]), _t(x["A"]), _t(x["B"]),
        _t(x["C"]), _t(x["D"]), z=_t(x["z"]), delta_bias=_t(x["bias"]),
        delta_softplus=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_softplus_has_no_threshold():
    """jax.nn.softplus is log(1 + exp(x)) for every x; F.softplus returns
    x itself above 20.  The port follows JAX."""
    import jax

    from dimsum_torch.ops.selective_scan import softplus

    x = np.linspace(-30, 30, 121, dtype=np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)
