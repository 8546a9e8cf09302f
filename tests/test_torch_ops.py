"""The port's dense ops against the JAX package's, from the same numpy
inputs: the depthwise conv in both directions, the dtype rules of the fused
add + norm and norm + modulate compositions in fp32 and bf16, the windowed
2-level Haar pack (also against the numpy oracles), and the tanh GELU.

Tolerances: fp32 results agree to rounding (1e-6 relative, or 2e-6 where a
mean over channels is reduced in another order); bf16 results are held to
one bf16 ulp (2^-8 relative, with an absolute floor of 1e-2 for values
near zero that went through a bf16 add)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dimsum_tpu.models.mlp import gelu_tanh as jax_gelu_tanh
from dimsum_tpu.ops.causal_conv1d import causal_conv1d as jax_causal_conv1d
from dimsum_tpu.ops import norms as jax_norms
from dimsum_tpu.ops import wavelet as jax_wavelet
from dimsum_torch.models.mlp import gelu_tanh
from dimsum_torch.ops import norms
from dimsum_torch.ops.causal_conv1d import causal_conv1d
from dimsum_torch.ops.wavelet import dwt_tokens_windowed, idwt_tokens_windowed
from tests.test_torch_convert import torch_one_thread  # noqa: F401

DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, name):
    """The same values as a JAX array and a torch tensor of dtype `name`."""
    jdt, tdt = DT[name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, name, rtol=None):
    assert str(got.dtype).split(".")[-1] == {
        "float32": "float32", "bfloat16": "bfloat16"}[str(want.dtype)]
    if name == "fp32":
        tol = dict(rtol=rtol or 1e-6, atol=rtol or 1e-6)
    else:
        tol = dict(rtol=2 ** -8, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_causal_conv1d_matches_jax(reverse, name):
    rng = np.random.default_rng(int(reverse))
    jx, tx = _pair(rng.standard_normal((2, 37, 24)), name)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jax_causal_conv1d(jx, w, b, activation="silu",
                                  reverse=reverse)
    got = causal_conv1d(tx, torch.from_numpy(w), torch.from_numpy(b),
                        activation="silu", reverse=reverse)
    _close(got, want, name)


def test_anticausal_conv_is_flipped_causal():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 19, 8)).astype(np.float32))
    w = torch.linspace(-1, 1, 32).reshape(8, 4)
    got = causal_conv1d(x, w, reverse=True)
    want = causal_conv1d(x.flip(1), w).flip(1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("residual_in_fp32", [False, True])
@pytest.mark.parametrize("is_rms", [False, True])
def test_fused_add_norm_matches_jax(name, with_residual, residual_in_fp32,
                                    is_rms):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((2, 16, 32)), name)
    jr, tr = (_pair(rng.standard_normal((2, 16, 32)), "fp32")
              if with_residual else (None, None))
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    b = None if is_rms else (0.1 * rng.standard_normal(32)).astype(
        np.float32)
    want, want_res = jax_norms.fused_add_norm(
        jx, w, b, residual=jr, residual_in_fp32=residual_in_fp32,
        is_rms=is_rms)
    got, got_res = norms.fused_add_norm(
        tx, torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        residual=tr, residual_in_fp32=residual_in_fp32, is_rms=is_rms)
    _close(got, want, name, rtol=2e-6)
    _close(got_res, want_res, "fp32" if residual_in_fp32 else name)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("parts", ["mod", "branch", "gate", "residual"])
def test_norm_modulate_matches_jax(name, parts):
    """parts: which operands join x: shift/scale only; + branch; + gated
    branch; + gated branch + fp32 residual (total emitted in fp32)."""
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((2, 16, 32)), name)
    jsh, tsh = _pair(0.3 * rng.standard_normal((2, 32)), name)
    jsc, tsc = _pair(0.3 * rng.standard_normal((2, 32)), name)
    kw_j, kw_t = dict(shift=jsh, scale=jsc), dict(shift=tsh, scale=tsc)
    if parts != "mod":
        jb, tb = _pair(rng.standard_normal((2, 16, 32)), name)
        kw_j["branch"], kw_t["branch"] = jb, tb
    if parts in ("gate", "residual"):
        jg, tg = _pair(rng.standard_normal((2, 32)), name)
        kw_j["gate"], kw_t["gate"] = jg, tg
    if parts == "residual":
        jr, tr = _pair(rng.standard_normal((2, 16, 32)), "fp32")
        kw_j.update(residual=jr, total_dtype=jnp.float32)
        kw_t.update(residual=tr, total_dtype=torch.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    want, want_total = jax_norms.norm_modulate(jx, w, eps=1e-5, is_rms=True,
                                               **kw_j)
    got, got_total = norms.norm_modulate(tx, torch.from_numpy(w), eps=1e-5,
                                         is_rms=True, **kw_t)
    _close(got, want, name, rtol=2e-6)
    _close(got_total, want_total, "fp32" if parts == "residual" else name)


@pytest.mark.parametrize("column_first", [False, True])
@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_dwt_tokens_windowed_matches_jax(column_first, name):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.standard_normal((2, 256, 8)), name)
    want = jax_wavelet.dwt_tokens_windowed(jx, 2, column_first=column_first)
    got = dwt_tokens_windowed(tx, 2, column_first=column_first)
    _close(got, want, name)
    want_inv = jax_wavelet.idwt_tokens_windowed(want, 2,
                                                column_first=column_first)
    got_inv = idwt_tokens_windowed(got, 2, column_first=column_first)
    _close(got_inv, want_inv, name)


@pytest.mark.parametrize("column_first", [False, True])
def test_dwt_tokens_windowed_matches_numpy_oracle(column_first):
    """The windowed pack is the oracle's dwt_tokens followed by the local
    scan, whose windows (side 16, patch 4) are the 4x4 dwt blocks: tokens
    (h p1 w p2) -> (h w p1 p2), or (w h p2 p1) column first."""
    x = np.random.default_rng(6).standard_normal((2, 256, 8))
    packed = jax_wavelet._np_dwt_tokens(x, 2).reshape(2, 4, 4, 4, 4, 8)
    order = (0, 3, 1, 4, 2, 5) if column_first else (0, 1, 3, 2, 4, 5)
    want = packed.transpose(order).reshape(2, 256, 8)
    got = dwt_tokens_windowed(torch.from_numpy(x), 2,
                              column_first=column_first)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    back = idwt_tokens_windowed(got, 2, column_first=column_first)
    np.testing.assert_allclose(
        back.numpy(), jax_wavelet._np_idwt_tokens(
            jax_wavelet._np_dwt_tokens(x, 2), 2), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-12, atol=1e-12)


def test_gelu_tanh_matches_jax():
    x = np.linspace(-8, 8, 401, dtype=np.float32)
    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu_tanh(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
