"""The last single-device flags of the JAX package, in the port, against
the JAX package on the CPU:

  * the bf16 residual stream (`residual_in_fp32=False`, the JAX bench's
    --bf16-residual): the plain versions of the add + norm and norm +
    modulate kernels on a bf16 residual against the Pallas kernels in
    interpret mode, their Functions' gradients against `jax.grad`, and the
    small DiM's forward, plain and with the fused switches, against the
    JAX model with the same field;
  * the wavelet packs (DIMSUM_DWT_CL, DIMSUM_WAVELET_ONE_REARRANGE,
    DIMSUM_FUSED_WAVELET): bit for bit the default routes where JAX calls
    them so (the channel-last and one-rearrange packs), the basis pack to
    rounding, each against its JAX twin;
  * DIMSUM_NORM_MXU: the norms' reductions by `_mxu_rowsum` against the
    JAX functions on that route (which JAX takes on the TPU backend only,
    so the test turns its gate on);
  * DIMSUM_FLASH_ATTN / DIMSUM_FULL_ATTN: the routing rule against the JAX
    `_sdpa`'s (its backend check passed, its kernels replaced by markers),
    and, at model level, a small DiT with Dh 64 heads at L 1024 under
    DIMSUM_FULL_ATTN=1 taking the full-block route (its plain version on
    the CPU) against the JAX model;
  * each switch through the CLI's factory: the port built under the
    environment against the JAX model under it.

Tolerances.  fp32 models 5e-5 (tests/test_torch_dim.py's); the bf16 models
5e-2 of the output's scale (tests/test_torch_dim.py's bf16 forward: the two
frameworks round at different places); the kernels' plain versions in
bf16: the rounded total bit for bit, the normalized output 1 bf16 ulp
(2**-7 relative), the gradients 1e-5 of scale in fp32 (the Functions'
tolerance in tests/test_torch_fused_ops.py)."""

import argparse
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import dimsum_tpu.models.attention as jax_attention
import dimsum_tpu.models.dim as jax_dim
import dimsum_tpu.ops.full_attention as jax_full_attention
import dimsum_tpu.ops.norms as jax_norms
from dimsum_tpu import cli as jax_cli
from dimsum_tpu.models.dim import DiM as JaxDiM, DiMConfig as JaxDiMConfig
from dimsum_tpu.models.dit import DiT as JaxDiT, DiTConfig as JaxDiTConfig
from dimsum_tpu.models.factory import create_model as jax_create_model
from dimsum_tpu.ops import wavelet as jw
from dimsum_torch import cli
from dimsum_torch.models import dim as port_dim
from dimsum_torch.models.attention import takes_full_block
from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.models.dit import DiT, DiTConfig
from dimsum_torch.models.factory import ENV_SWITCHES
from dimsum_torch.ops import full_attention as port_fa
from dimsum_torch.ops import norms as pn
from dimsum_torch.ops import wavelet as pw
from dimsum_torch.ops.scan_orders import local_scan
from tests.test_torch_convert import (PUBLISHED, SMALL,  # noqa: F401
                                      torch_one_thread)
from tests.test_torch_dit import jax_port_pair, model_inputs

BF16_TOL = 5e-2


def _scaled(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the bf16 residual: the kernels' plain versions
# ---------------------------------------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("is_rms", [True, False])
def test_add_norm_bf16_residual_matches_pallas(monkeypatch, is_rms):
    """add_norm_ref on a bf16 residual with the total rounded to bf16
    against the Pallas `_add_norm_kernel` (interpret mode) and the JAX
    `fused_add_norm(residual_in_fp32=False)` rounding of its fp32 total;
    the Function's gradients against `jax.grad` through the kernel's
    custom VJP."""
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    rng = np.random.default_rng(0)
    x, res = _bf16(rng, 2, 16, 128), _bf16(rng, 2, 16, 128, scale=3.0)
    w = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = None if is_rms else (0.1 * rng.standard_normal(128)).astype(
        np.float32)
    jx, jres = jnp.asarray(x, jnp.bfloat16), jnp.asarray(res, jnp.bfloat16)
    jb = None if b is None else jnp.asarray(b)
    want_out, want_res = jax_norms.fused_add_norm(
        jx, jnp.asarray(w), jb, residual=jres, residual_in_fp32=False,
        is_rms=is_rms)
    tx = _t(x).to(torch.bfloat16)
    tres = _t(res).to(torch.bfloat16)
    out, total = pn.add_norm_ref(tx.reshape(-1, 128), tres.reshape(-1, 128),
                                 _t(w), None if b is None else _t(b), 1e-5,
                                 is_rms, torch.bfloat16, torch.bfloat16)
    assert total.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        total.float().numpy().reshape(2, 16, 128),
        np.asarray(want_res.astype(jnp.float32)))
    np.testing.assert_allclose(out.float().numpy().reshape(2, 16, 128),
                               np.asarray(want_out.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)
    # the route through fused_add_norm with the kernel switch
    got_out, got_res = pn.fused_add_norm(
        tx, _t(w), None if b is None else _t(b), residual=tres,
        residual_in_fp32=False, is_rms=is_rms, kernel=True)
    assert got_res.dtype == torch.bfloat16
    assert torch.equal(got_res.reshape(-1, 128), total)

    # gradients in fp32 of the kernel route, bf16 residual: the Function
    # against jax.grad through `_add_norm_op`
    gx, gres = rng.standard_normal((2, 16, 128)).astype(np.float32), \
        rng.standard_normal((2, 16, 128)).astype(np.float32)

    def jloss(x_, r_, w_):
        o, r = jax_norms.fused_add_norm(x_, w_, jb, residual=r_,
                                        residual_in_fp32=False,
                                        is_rms=is_rms)
        return ((o.astype(jnp.float32) * gx).sum()
                + (r.astype(jnp.float32) * gres).sum())

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(res, jnp.bfloat16), jnp.asarray(w))
    xs = _t(x).requires_grad_(True)
    rs = _t(res).to(torch.bfloat16).requires_grad_(True)
    ws = _t(w).requires_grad_(True)
    o, r = pn.fused_add_norm(xs, ws, None if b is None else _t(b),
                             residual=rs, residual_in_fp32=False,
                             is_rms=is_rms, kernel=True)
    assert r.dtype == torch.float32  # x's dtype: the stream's
    ((o * _t(gx)).sum() + (r.float() * _t(gres)).sum()).backward()
    assert rs.grad.dtype == torch.bfloat16
    for got, want, tol in zip((xs.grad, rs.grad, ws.grad), jgrads,
                              (1e-5, 2 ** -7, 1e-5)):
        _scaled(got.float().numpy(), np.asarray(want, np.float32), tol)


def test_norm_modulate_bf16_residual_matches_pallas(monkeypatch):
    """norm_modulate_ref on a bf16 residual (the deferred top site of a
    bf16 stream: base + gate * branch + residual, the total rounded to
    bf16 and normalized from the rounded value) against the Pallas
    `_norm_mod_kernel` in interpret mode; NormModulateFn's gradients
    against `jax.grad`."""
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    rng = np.random.default_rng(1)
    B, L, D = 2, 16, 128
    base, branch = _bf16(rng, B, L, D), _bf16(rng, B, L, D)
    res = _bf16(rng, B, L, D, scale=3.0)
    gate, shift, scale = (_bf16(rng, B, D, scale=0.3) for _ in range(3))
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in dict(
        base=base, branch=branch, res=res, gate=gate, shift=shift,
        scale=scale).items()}
    want_out, want_total = jax_norms.norm_modulate(
        j["base"], jnp.asarray(w), branch=j["branch"], gate=j["gate"],
        residual=j["res"], shift=j["shift"], scale=j["scale"],
        total_dtype=jnp.bfloat16, fuse=True)
    t = {k: _t(v).to(torch.bfloat16) for k, v in dict(
        base=base, branch=branch, res=res, gate=gate, shift=shift,
        scale=scale).items()}
    out, total = pn.norm_modulate_ref(
        t["base"], _t(w), None, t["branch"], t["gate"], t["res"],
        t["shift"], t["scale"], total_dtype=torch.bfloat16)
    np.testing.assert_array_equal(total.float().numpy(),
                                  np.asarray(want_total, np.float32))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want_out, np.float32),
                               rtol=2 ** -6, atol=2 ** -6)

    leaves = {k: v.float().requires_grad_(True) for k, v in t.items()}
    leaves["res"] = t["res"].clone().requires_grad_(True)  # bf16 residual
    wl = _t(w).requires_grad_(True)
    o, tot = pn.NormModulateFn.apply(
        leaves["base"], wl, None, leaves["branch"], leaves["gate"],
        leaves["res"], leaves["shift"], leaves["scale"], 1e-5, True,
        torch.float32)
    g1, g2 = rng.standard_normal((2, B, L, D)).astype(np.float32)
    ((o * _t(g1)).sum() + (tot * _t(g2)).sum()).backward()

    def jloss(base_, branch_, gate_, res_, shift_, scale_, w_):
        o_, t_ = jax_norms.norm_modulate(
            base_, w_, branch=branch_, gate=gate_, residual=res_,
            shift=shift_, scale=scale_, total_dtype=jnp.float32, fuse=True)
        return (o_ * g1).sum() + (t_ * g2).sum()

    names = ("base", "branch", "gate", "res", "shift", "scale")
    args = [j[k].astype(jnp.float32) if k != "res" else j["res"]
            for k in names]
    jg = jax.grad(jloss, argnums=tuple(range(7)))(*args, jnp.asarray(w))
    for name, want in zip(names + ("w",), jg):
        got = wl.grad if name == "w" else leaves[name].grad
        _scaled(got.float().numpy(), np.asarray(want, np.float32),
                2 ** -7 if name == "res" else 1e-5, name)


# ---------------------------------------------------------------------------
# the bf16 residual: the small DiM
# ---------------------------------------------------------------------------

def _small_pair(seed, dtype, **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel = JaxDiM(JaxDiMConfig(**SMALL, **PUBLISHED, dtype=jdt,
                                 residual_in_fp32=False))
    params, port = jax_port_pair(jmodel, DiM(DiMConfig(
        **SMALL, dtype=tdt, residual_in_fp32=False, **kw)), seed, img=32)
    return jmodel, params, port.eval()


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_residual_dim_forward_tracks_jax(monkeypatch, fused):
    """The small DiM in bf16 with its residual stream in bf16, against the
    JAX model with `residual_in_fp32=False` (with `fused`: the add + norm
    and norm + modulate switches and the deferred tail at 2 in both, the
    JAX kernels in interpret mode); every block's residual is bf16."""
    switches = dict(pallas_norm=True, fused_norm=True, pending_tail=2) \
        if fused else {}
    if fused:
        for name, v in (("DIMSUM_NORM_INTERPRET", "1"),
                        ("DIMSUM_PENDING_TAIL", "2")):
            monkeypatch.setenv(name, v)
    jmodel, params, port = _small_pair(2, "bf16", **switches)
    x, t, y = model_inputs(3, img=32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(jmodel.apply)(params, x, t, y))
    residuals = []
    for blk in port.blocks:
        blk.register_forward_hook(
            lambda m, a, out: residuals.append(out[1].dtype))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(y).long()).numpy()
    assert residuals == [torch.bfloat16] * len(port.blocks)
    _scaled(got, want, BF16_TOL, "bf16 residual forward")


# ---------------------------------------------------------------------------
# the wavelet packs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", [16, 32])
@pytest.mark.parametrize("mode", ["plain", "grid_t", "win_row", "win_col"])
def test_dwt_cl_is_bitwise_the_default_route(side, mode):
    """`dwt_tokens_cl` (and its inverse) in each mode equals the
    channel-major composition it stands for bit for bit (as the JAX pack
    does, tests/test_ops.py), and the JAX `dwt_tokens_cl` bit for bit."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, side * side, 32)).astype(np.float32)
    window = mode.startswith("win")
    kw = dict(window_scan=window, grid_transpose=mode == "grid_t",
              column_first=mode == "win_col")
    got = pw.dwt_tokens_cl(_t(x), 2, **kw)
    ref = pw.dwt_tokens(_t(x), 2)
    if window:
        ref = local_scan(ref, w=side // 4, H=side, W=side,
                         column_first=kw["column_first"])
    elif kw["grid_transpose"]:
        ref = ref.reshape(2, side, side, 32).transpose(1, 2).reshape(
            2, side * side, 32)
    assert torch.equal(got, ref)
    np.testing.assert_allclose(pw.idwt_tokens_cl(got, 2, **kw).numpy(), x,
                               atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jw.dwt_tokens_cl(jnp.asarray(x), 2, **kw)))
    np.testing.assert_array_equal(
        pw.idwt_tokens_cl(got, 2, **kw).numpy(),
        np.asarray(jw.idwt_tokens_cl(jnp.asarray(got.numpy()), 2, **kw)))


@pytest.mark.parametrize("column_first", [False, True])
def test_one_rearrange_at_512_is_bitwise_the_two_steps(column_first):
    """At side 32 (512 px; window 8 over 4-blocks) the one-rearrange pack
    equals dwt_tokens + local_scan bit for bit, and the JAX one."""
    x = np.random.default_rng(5).standard_normal((2, 1024, 16)).astype(
        np.float32)
    got = pw.dwt_tokens_windowed(_t(x), 2, column_first=column_first)
    ref = local_scan(pw.dwt_tokens(_t(x), 2), w=8, H=32, W=32,
                     column_first=column_first)
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jw.dwt_tokens_windowed(jnp.asarray(x), 2,
                               column_first=column_first)))
    back = pw.idwt_tokens_windowed(got, 2, column_first=column_first)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jw.idwt_tokens_windowed(jnp.asarray(got.numpy()), 2,
                                column_first=column_first)))


@pytest.mark.parametrize("side", [16, 32])
@pytest.mark.parametrize("column_first", [False, True])
def test_fused_wavelet_pack_matches_jax(side, column_first):
    """The basis pack against the composition (to rounding: one product
    with the packet basis reassociates the butterflies' sums) and against
    the JAX basis pack."""
    x = np.random.default_rng(6).standard_normal(
        (2, side * side, 32)).astype(np.float32)
    got = pw.wavelet_pack_windowed(_t(x), 2, column_first=column_first)
    ref = local_scan(pw.dwt_tokens(_t(x), 2), w=side // 4, H=side, W=side,
                     column_first=column_first)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jw.wavelet_pack_windowed(jnp.asarray(x), 2,
                                 column_first=column_first)), atol=1e-6)
    back = pw.wavelet_unpack_windowed(got, 2, column_first=column_first)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    assert np.array_equal(pw._packet_basis(2)[0], jw._packet_basis(2)[0])


# ---------------------------------------------------------------------------
# DIMSUM_NORM_MXU
# ---------------------------------------------------------------------------

def test_norm_mxu_matches_the_jax_route(monkeypatch):
    """rms_norm / layer_norm with `mxu` against the JAX functions with
    their MXU gate on, and `_mxu_rowsum` against JAX's."""
    monkeypatch.setattr(jax_norms, "_norm_mxu_reductions", lambda: True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 8, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    np.testing.assert_allclose(
        pn._mxu_rowsum(_t(x)).numpy(),
        np.asarray(jax_norms._mxu_rowsum(jnp.asarray(x))),
        atol=1e-6 * np.abs(x).sum(-1).max())  # 256 fp32 sums, any order
    np.testing.assert_allclose(
        pn.rms_norm(_t(x), _t(w), mxu=True).numpy(),
        np.asarray(jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pn.layer_norm(_t(x), _t(w), _t(b), mxu=True).numpy(),
        np.asarray(jax_norms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# DIMSUM_FLASH_ATTN / DIMSUM_FULL_ATTN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", ["auto", "0", "1"])
@pytest.mark.parametrize("full", ["auto", "0", "1"])
def test_attention_routing_matches_jax(monkeypatch, flash, full):
    """`takes_full_block` against the JAX `_sdpa`'s choice with its TPU
    backend check passed and its two kernels replaced by markers (the
    library flash kernel made unimportable, so that it falls back to XLA
    as JAX does where it cannot import it), at L 256 / 1024 / 2048 and
    Dh 32 / 64 / 72."""
    for name, value in (("DIMSUM_FLASH_ATTN", flash),
                        ("DIMSUM_FULL_ATTN", full)):
        if value == "auto":
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    monkeypatch.setitem(sys.modules,
                        "jax.experimental.pallas.ops.tpu.flash_attention",
                        None)
    monkeypatch.setattr(jax_attention, "_FLASH_IMPORT_WARNED", True)
    taken = []
    monkeypatch.setattr(jax_full_attention, "full_block_attention",
                        lambda q, k, v, s: taken.append(1) or q)
    for L in (256, 1024, 2048):
        for dh in (32, 64, 72):
            q = jnp.zeros((1, L, 1, dh))
            taken.clear()
            jax_attention._sdpa(q, q, q)
            assert takes_full_block(L, dh, flash, full) == bool(taken), \
                (L, dh)


def test_full_attn_dit_at_L1024_takes_the_full_block_route(monkeypatch):
    """A small DiT with Dh 64 heads (hidden 128, 2 heads) at L 1024 built
    by the CLI's factory under DIMSUM_FULL_ATTN=1 takes the full-block
    route (its plain version on the CPU, counted) at every block, and
    matches the JAX DiT (XLA attention on the CPU) at 5e-5."""
    cfg_kw = dict(img_resolution=64, patch_size=2, hidden_size=128, depth=2,
                  num_heads=2, num_classes=10)
    monkeypatch.setenv("DIMSUM_FULL_ATTN", "1")
    args = argparse.Namespace(model="DiT-S/2", image_size=512,
                              num_in_channels=4, label_dropout=0.1,
                              num_classes=10, learn_sigma=False, bf16=False,
                              scan_impl=None)
    full_attn = cli.model_config(args).full_attn
    assert full_attn == "1"
    jmodel = JaxDiT(JaxDiTConfig(**cfg_kw))
    params, port = jax_port_pair(jmodel, DiT(DiTConfig(
        **cfg_kw, full_attn=full_attn)), img=64)
    calls = []
    ref = port_fa.full_attention_ref
    monkeypatch.setattr(port_fa, "full_attention_ref",
                        lambda *a: calls.append(1) or ref(*a))
    x, t, y = model_inputs(4, img=64)
    want = np.asarray(jax.jit(jmodel.apply)(params, x, t, y))
    with torch.no_grad():
        got = port.eval()(_t(x), _t(t), _t(y).long()).numpy()
    assert len(calls) == 2  # one a block
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_full_attn_dim_at_L1024_takes_the_full_block_route(monkeypatch):
    """A DiM whose heads are 64 wide (hidden 1024: the DiT block's 16
    heads and the cross fusion's 8 on each half) at L 1024, one combined
    block and the shared DiT block, built by the CLI's factory under
    DIMSUM_FULL_ATTN=1: all three attentions take the full-block route
    (its plain version on the CPU, counted), against the JAX DiM (XLA's
    attention on the CPU) at 5e-5.  tests/test_torch_512.py's DiM has
    heads of 8, where both packages take SDPA."""
    monkeypatch.setenv("DIMSUM_FULL_ATTN", "1")
    monkeypatch.setitem(jax_dim.DiM_models, "DiM-T/2",
                        lambda **kw: jax_dim._zoo_cfg(1, 1024, 2, **kw))
    monkeypatch.setitem(port_dim.DiM_models, "DiM-T/2",
                        lambda **kw: port_dim._zoo_cfg(1, 1024, 2, **kw))
    argv = ["--model", "DiM-T/2", "--num-classes", "10", "--label-dropout",
            "0.1", "--block-type", "combined", "--bimamba-type", "none",
            "--rms-norm", "--cond-mamba", "--learnable-pe",
            "--use-attn-every-k-layers", "1", "--image-size", "512"]
    jmodel, _ = jax_create_model(_parse(jax_cli, argv))
    cfg = cli.model_config(_parse(cli, argv))
    assert cfg.full_attn == "1" and cfg.grid_size ** 2 == 1024
    params, port = jax_port_pair(jmodel, DiM(cfg), img=64)
    calls = []
    ref = port_fa.full_attention_ref
    monkeypatch.setattr(port_fa, "full_attention_ref",
                        lambda *a: calls.append(a[0].shape) or ref(*a))
    x, t, y = model_inputs(5, n=1, img=64)
    want = np.asarray(jax.jit(jmodel.apply)(params, x, t, y))
    with torch.no_grad():
        got = port.eval()(_t(x), _t(t), _t(y).long()).numpy()
    # the cross fusion's two directions and the DiT block, Dh 64 each
    assert [c[1:] for c in calls] == [(1024, 8, 64)] * 2 + [(1024, 16, 64)]
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


# ---------------------------------------------------------------------------
# each switch through the factory, model against model
# ---------------------------------------------------------------------------

ARGV = ["--model", "DiM-T/2", "--num-classes", "10", "--label-dropout",
        "0.1", "--block-type", "combined", "--bimamba-type", "none",
        "--rms-norm", "--cond-mamba", "--learnable-pe",
        "--use-attn-every-k-layers", "2"]


def _parse(module, argv):
    p = argparse.ArgumentParser()
    module.add_model_args(p)
    module.add_moe_args(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("switch, image_size", [
    ("DIMSUM_DWT_CL", 256), ("DIMSUM_DWT_CL", 512),
    ("DIMSUM_FUSED_WAVELET", 256), ("DIMSUM_WAVELET_ONE_REARRANGE", 512),
    ("DIMSUM_NORM_MXU", 256), ("DIMSUM_FLASH_ATTN", 256),
    ("DIMSUM_FULL_ATTN", 512)])
def test_switch_through_the_factory_matches_jax(monkeypatch, switch,
                                                image_size):
    """A narrow DiM (hidden 64, depth 2) that the CLI's factory builds with
    the switch set to "1", against the JAX model its `create_model` builds
    under the same environment (DIMSUM_NORM_MXU with the JAX gate on:
    JAX takes it on the TPU backend only), at 5e-5."""
    for name in ENV_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(switch, "1")
    if switch == "DIMSUM_NORM_MXU":
        monkeypatch.setattr(jax_norms, "_norm_mxu_reductions", lambda: True)
    monkeypatch.setitem(jax_dim.DiM_models, "DiM-T/2",
                        lambda **kw: jax_dim._zoo_cfg(2, 64, 2, **kw))
    monkeypatch.setitem(port_dim.DiM_models, "DiM-T/2",
                        lambda **kw: port_dim._zoo_cfg(2, 64, 2, **kw))
    argv = ARGV + ["--image-size", str(image_size)]
    jmodel, jcfg = jax_create_model(_parse(jax_cli, argv))
    cfg = cli.model_config(_parse(cli, argv))
    field = ENV_SWITCHES[switch]
    assert getattr(cfg, field) in (True, "1")
    img = image_size // 8
    params, port = jax_port_pair(jmodel, DiM(cfg), img=img)
    x, t, y = model_inputs(8, img=img)
    want = np.asarray(jax.jit(jmodel.apply)(params, x, t, y))
    with torch.no_grad():
        got = port.eval()(_t(x), _t(t), _t(y).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
