"""The plain versions of the port's three fused kernels (add + norm, norm +
modulate, conv + x_proj) against the JAX package's Pallas kernels, run as
its own tests run them on the CPU: the norm kernels with
`DIMSUM_NORM_INTERPRET=1`, conv + x_proj inside
`pltpu.force_tpu_interpret_mode()`.  Also the autograd Functions' gradients
against `jax.grad` through the JAX `custom_vjp`s, and the port's gates
against the JAX gates on both sides of each limit.

Tolerances: fp32 1e-5 (the same fp32 ops in other summation orders); bf16
one bf16 step, 1.6e-2 of each tensor's largest value; conv + x_proj as the
JAX package's own test holds its kernel (x_conv 1e-6 fp32 / 1e-2 bf16,
x_dbl 1e-5 / 2e-2); gradients 1e-4 (the JAX test's for these
backwards)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dimsum_tpu.ops import conv_xproj as jax_cx
from dimsum_tpu.ops import norms as jax_norms
from dimsum_torch.ops import norms
from dimsum_torch.ops.conv_xproj import (conv_xproj, conv_xproj_ref,
                                         conv_xproj_supported)
from dimsum_torch.ops.norms import (add_norm_ref, add_norm_supported,
                                    fused_add_norm, norm_modulate,
                                    norm_modulate_ref,
                                    norm_modulate_supported)
from tests.test_torch_convert import torch_one_thread  # noqa: F401

DTYPES = {"fp32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# (has_branch, has_gate, has_res, has_mod, is_rms, has_w): the call-site
# flag sets of tests/test_norm_modulate.py
CASES = [
    (True, True, False, True, True, True),    # norm_2
    (True, False, False, True, True, True),   # gate-less fused add
    (False, False, True, False, True, True),  # plain add + norm
    (True, True, False, True, False, False),  # DiT second LN
    (False, False, False, True, False, False),  # DiT first LN / FinalLayer
    (True, True, True, False, True, True),    # deferred top (pending tail)
]


def _make(B=2, L=32, D=256, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((B, L, D)).astype(f),
        branch=rng.standard_normal((B, L, D)).astype(f),
        res=rng.standard_normal((B, L, D)).astype(f),
        gate=(0.5 * rng.standard_normal((B, D))).astype(f),
        shift=(0.3 * rng.standard_normal((B, D))).astype(f),
        scale=(0.3 * rng.standard_normal((B, D))).astype(f),
        w=(1 + 0.1 * rng.standard_normal(D)).astype(f),
        b=(0.1 * rng.standard_normal(D)).astype(f))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)


def _assert_scaled(got, want, tol, name=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _tol(dtype):
    return 1e-5 if dtype == "fp32" else 1.6e-2


# ---------------------------------------------------------------------------
# (a) the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_norm_modulate_ref_matches_pallas(case, dtype, monkeypatch):
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    has_branch, has_gate, has_res, has_mod, is_rms, has_w = case
    jdt, tdt = DTYPES[dtype]
    v = _make()
    opt = dict(branch=has_branch, gate=has_gate, residual=has_res,
               shift=has_mod, scale=has_mod)
    src = dict(branch="branch", gate="gate", residual="res", shift="shift",
               scale="scale")
    eps = 1e-5 if is_rms else 1e-6
    total_dtype = "fp32" if has_res else dtype
    w = v["w"] if has_w else None
    b = v["b"] if has_w and not is_rms else None
    jkw = {k: (None if not on else jnp.asarray(
        v[src[k]], jnp.float32 if k == "residual" else jdt))
        for k, on in opt.items()}
    want_out, want_tot = jax_norms.norm_modulate(
        jnp.asarray(v["x"], jdt), None if w is None else jnp.asarray(w),
        None if b is None else jnp.asarray(b), eps=eps, is_rms=is_rms,
        total_dtype=jnp.float32 if has_res else None, **jkw)
    tkw = {k: (None if not on else _t(
        v[src[k]], torch.float32 if k == "residual" else tdt))
        for k, on in opt.items()}
    out, tot = norm_modulate_ref(
        _t(v["x"], tdt), _t(w), _t(b), eps=eps, is_rms=is_rms,
        total_dtype=DTYPES[total_dtype][1], **tkw)
    assert out.dtype == tdt and tot.dtype == DTYPES[total_dtype][1]
    _assert_scaled(out, want_out, _tol(dtype), "out")
    _assert_scaled(tot, want_tot, _tol(dtype), "total")


@pytest.mark.parametrize("is_rms", [True, False])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_add_norm_ref_matches_pallas(is_rms, dtype, monkeypatch):
    """The add + norm site: x in the compute dtype, the residual fp32."""
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    jdt, tdt = DTYPES[dtype]
    v = _make(seed=1)
    b = None if is_rms else v["b"]
    eps = 1e-5 if is_rms else 1e-6
    want_out, want_tot = jax_norms.fused_add_norm(
        jnp.asarray(v["x"], jdt), jnp.asarray(v["w"]),
        None if b is None else jnp.asarray(b), residual=jnp.asarray(v["res"]),
        eps=eps, is_rms=is_rms)
    D = v["x"].shape[-1]
    out, tot = add_norm_ref(_t(v["x"], tdt).reshape(-1, D),
                            _t(v["res"]).reshape(-1, D), _t(v["w"]), _t(b),
                            eps, is_rms, tdt)
    assert out.dtype == tdt and tot.dtype == torch.float32
    _assert_scaled(out.reshape(v["x"].shape), want_out, _tol(dtype), "out")
    _assert_scaled(tot.reshape(v["x"].shape), want_tot, 1e-5, "total")
    # the site's entry point, on CPU tensors, through the Function
    got_out, got_tot = fused_add_norm(
        _t(v["x"], tdt), _t(v["w"]), _t(b), residual=_t(v["res"]), eps=eps,
        is_rms=is_rms, kernel=True)
    torch.testing.assert_close(got_out.reshape(-1, D), out, rtol=0, atol=0)
    torch.testing.assert_close(got_tot.reshape(-1, D), tot, rtol=0, atol=0)


def _conv_inputs(B=2, L=64, D=256, W=4, R=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, D)).astype(np.float32),
            (0.3 * rng.standard_normal((D, W))).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            (rng.standard_normal((D, R)) / np.sqrt(D)).astype(np.float32))


@pytest.mark.parametrize("R", [96, 68])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv_xproj_ref_matches_pallas(R, reverse, dtype):
    jdt, tdt = DTYPES[dtype]
    x, cw, cb, wxp = _conv_inputs(R=R, seed=R)
    with pltpu.force_tpu_interpret_mode():
        want_c, want_d = jax_cx.conv_xproj(jnp.asarray(x, jdt),
                                           jnp.asarray(cw), jnp.asarray(cb),
                                           jnp.asarray(wxp), reverse)
    # the port takes x_proj.weight in the torch layout (R, D)
    got_c, got_d = conv_xproj(_t(x, tdt), _t(cw), _t(cb), _t(wxp.T.copy()),
                              reverse)
    assert got_c.dtype == tdt and got_d.dtype == torch.float32
    assert got_d.shape == (2, 64, R)
    ctol, dtol = (1e-6, 1e-5) if dtype == "fp32" else (1e-2, 2e-2)
    np.testing.assert_allclose(got_c.float().numpy(),
                               np.asarray(want_c, np.float32),
                               rtol=ctol, atol=ctol)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=dtol, atol=dtol)
    ref_c, ref_d = conv_xproj_ref(_t(x, tdt), _t(cw), _t(cb),
                                  _t(wxp.T.copy()), reverse)
    torch.testing.assert_close(got_c, ref_c, rtol=0, atol=0)
    torch.testing.assert_close(got_d, ref_d, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (c) the Functions' gradients against jax.grad through the custom_vjps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[5]])
def test_norm_modulate_fn_grads_match_jax(case, monkeypatch):
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    has_branch, has_gate, has_res, has_mod, is_rms, has_w = case
    v = _make(L=16, D=128, seed=2)
    names = ["x", "w", "branch", "gate", "res", "shift", "scale"]
    on = dict(x=True, w=has_w, branch=has_branch, gate=has_gate, res=has_res,
              shift=has_mod, scale=has_mod)
    args = [v[n] if on[n] else None for n in names]
    eps = 1e-5 if is_rms else 1e-6
    tdt = torch.float32 if has_res else None

    def jloss(x, w, br, g, res, sh, sc):
        out, tot = jax_norms.norm_modulate(
            x, w, None, branch=br, gate=g, residual=res, shift=sh, scale=sc,
            eps=eps, is_rms=is_rms, total_dtype=jnp.float32 if has_res
            else None)
        return jnp.sum(out ** 2) + jnp.sum(tot ** 2)

    idx = [i for i, a in enumerate(args) if a is not None]
    want = jax.grad(jloss, argnums=idx)(
        *[None if a is None else jnp.asarray(a) for a in args])

    leaves = [None if a is None else _t(a).requires_grad_(True)
              for a in args]
    x, w, br, g, res, sh, sc = leaves
    out, tot = norm_modulate(x, w, branch=br, gate=g, residual=res,
                             shift=sh, scale=sc, eps=eps, is_rms=is_rms,
                             total_dtype=tdt, fuse=True)
    ((out ** 2).sum() + (tot ** 2).sum()).backward()
    for i, wg in zip(idx, want):
        _assert_scaled(leaves[i].grad, wg, 1e-4, names[i])


@pytest.mark.parametrize("is_rms", [True, False])
def test_add_norm_fn_grads_match_jax(is_rms, monkeypatch):
    """The analytic backward, with cotangents on both outputs."""
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    v = _make(L=16, D=128, seed=3)
    eps = 1e-5 if is_rms else 1e-6
    args = [v["x"], v["res"], v["w"]] + ([] if is_rms else [v["b"]])

    def jloss(x, res, w, b=None):
        out, tot = jax_norms.fused_add_norm(x, w, b, residual=res, eps=eps,
                                            is_rms=is_rms)
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(tot))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    out, tot = fused_add_norm(leaves[0], leaves[2],
                              leaves[3] if not is_rms else None,
                              residual=leaves[1], eps=eps, is_rms=is_rms,
                              kernel=True)
    ((out ** 2).sum() + torch.sin(tot).sum()).backward()
    for name, leaf, wg in zip(("x", "res", "w", "b"), leaves, want):
        _assert_scaled(leaf.grad, wg, 1e-4, name)


@pytest.mark.parametrize("reverse", [False, True])
def test_conv_xproj_fn_grads_match_jax(reverse):
    x, cw, cb, wxp = _conv_inputs(L=32, D=128, R=36, seed=4)

    def jloss(*a):
        with pltpu.force_tpu_interpret_mode():
            xc, xd = jax_cx.conv_xproj(*a, reverse)
        return jnp.sum(xc * 0.5) + jnp.sum(xd ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, cw, cb, wxp)))
    leaves = [_t(a).requires_grad_(True) for a in (x, cw, cb, wxp.T.copy())]
    xc, xd = conv_xproj(*leaves, reverse)
    ((xc * 0.5).sum() + (xd ** 2).sum()).backward()
    for name, leaf, wg in zip(("x", "conv_w", "conv_b"), leaves, want):
        _assert_scaled(leaf.grad, wg, 1e-4, name)
    _assert_scaled(leaves[3].grad.t(), want[3], 1e-4, "w_xp")


def test_conv_xproj_fp32_weight_gets_its_gradient_through_the_cast():
    """bf16 x with the training build's fp32 x_proj.weight: the product
    takes the weight rounded to bf16, and the gradient arrives in fp32,
    through the cast, rounded to bf16 on the way as the JAX cast rounds
    it (so one bf16 step)."""
    x, cw, cb, wxp = _conv_inputs(L=16, D=128, R=36, seed=5)
    w = _t(wxp.T.copy()).requires_grad_(True)
    xb = _t(x, torch.bfloat16)
    xc, xd = conv_xproj(xb, _t(cw), _t(cb), w)
    want_c, want_d = conv_xproj_ref(xb, _t(cw), _t(cb), w.detach().bfloat16())
    torch.testing.assert_close(xd, want_d, rtol=0, atol=0)
    xd.sum().backward()
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(
        w.grad, xc.float().sum((0, 1))[None].expand_as(w), rtol=2 ** -8,
        atol=0)


# ---------------------------------------------------------------------------
# (d) the gates against the JAX gates, on both sides of each limit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (2, 32, 256), (2, 32, 200), (2, 32, 4096), (1, 8, 4224), (2, 12, 128),
    (2, 24, 128), (3, 4, 128), (1, 8, 128), (16, 128)])
def test_norm_modulate_gate_matches_jax(shape, monkeypatch):
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    want = jax_norms._fused_norm_mod_ok(np.broadcast_to(np.float32(0),
                                                        shape))
    assert norm_modulate_supported(torch.empty(shape, device="meta")) == want


@pytest.mark.parametrize("shape", [
    (3, 4, 128), (2, 4, 128), (16, 256), (8, 4096), (8, 4224), (8, 200),
    (7, 128), (5, 3, 384)])
def test_add_norm_gate_matches_jax(shape, monkeypatch):
    monkeypatch.setenv("DIMSUM_NORM_INTERPRET", "1")
    want = jax_norms._add_norm_pallas_ok(np.broadcast_to(np.float32(0),
                                                         shape))
    assert add_norm_supported(torch.empty(shape, device="meta")) == want


@pytest.mark.parametrize("shape, R", [
    ((2, 256, 1024), 64), ((2, 256, 1000), 64), ((2, 256, 128), 512),
    ((2, 256, 128), 513), ((1, 2048, 1024), 64), ((1, 2049, 1024), 64),
    ((1, 4096, 256), 68), ((1, 4097, 256), 68)])
def test_conv_xproj_gate_matches_jax(shape, R, monkeypatch):
    monkeypatch.setenv("DIMSUM_CONV_XPROJ", "1")
    want = jax_cx.conv_xproj_supported(
        np.broadcast_to(np.float32(0), shape), np.zeros((1, R)))
    assert conv_xproj_supported(torch.empty(shape, device="meta"), R) == want


def test_unsupported_shapes_take_the_composition(monkeypatch):
    """A switch that is on does not reach a kernel whose gate refuses the
    shape, nor add + norm without a residual: the composition runs, bit for
    bit (routing, not a fallback)."""
    def refuse(*args):
        raise AssertionError("a kernel route was taken")

    monkeypatch.setattr(norms.AddNormFn, "apply", refuse)
    monkeypatch.setattr(norms.NormModulateFn, "apply", refuse)
    v = _make(D=192)
    x, w, br = _t(v["x"]), _t(v["w"]), _t(v["branch"])
    sh, sc = _t(v["shift"]), _t(v["scale"])
    got = norm_modulate(x, w, branch=br, shift=sh, scale=sc, fuse=True)
    want = norm_modulate(x, w, branch=br, shift=sh, scale=sc, fuse=False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    res = _t(v["res"])
    got = fused_add_norm(x, w, residual=res, kernel=True)
    want = fused_add_norm(x, w, residual=res)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    v = _make()
    got = fused_add_norm(_t(v["x"]), _t(v["w"]), kernel=True)
    want = fused_add_norm(_t(v["x"]), _t(v["w"]))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
