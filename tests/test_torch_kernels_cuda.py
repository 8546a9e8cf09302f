"""The port's CUDA kernels against their plain PyTorch versions.  Imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tests that need a card skip without one (decided in the `cuda` fixture).
Tolerances: fp32, 1e-4 (the kernel computes exp as exp2 and sums in another
order than the plain recurrence); bf16, 1.6e-2 (the same fp32 value may
round to neighbouring bf16 numbers: 2 ulp = 2^-6 relative)."""

import math

import pytest
import torch

from dimsum_torch.ops.selective_scan import (selective_scan_cuda,
                                             selective_scan_dtlow)


def scan_inputs(device, dtype, batch=2, L=64, dim=16, n=16, r=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    dt = torch.exp(torch.rand(dim, generator=g)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    x = dict(u=torch.randn(batch, L, dim, generator=g),
             dt_low=torch.randn(batch, L, r, generator=g),
             dt_w=torch.randn(r, dim, generator=g) / math.sqrt(r),
             A=-torch.exp(0.5 * torch.randn(dim, n, generator=g)),
             B=torch.randn(batch, L, n, generator=g),
             C=torch.randn(batch, L, n, generator=g),
             D=1 + 0.1 * torch.randn(dim, generator=g),
             z=torch.randn(batch, L, dim, generator=g),
             delta_bias=dt + torch.log(-torch.expm1(-dt)))
    fp32 = ("A", "D", "delta_bias")
    return {k: v.to(device, torch.float32 if k in fp32 else dtype)
            for k, v in x.items()}


def _args(x):
    return [x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C", "D")]


def test_cuda_route_refuses_cpu_tensors():
    x = scan_inputs("cpu", torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        selective_scan_cuda(*_args(x))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        selective_scan_dtlow(*_args(x), impl="cuda")


def test_cpu_tensors_take_the_plain_version():
    x = scan_inputs("cpu", torch.float32)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    torch.testing.assert_close(selective_scan_dtlow(*_args(x), **kw),
                               selective_scan_dtlow(*_args(x), impl="ref",
                                                    **kw),
                               rtol=0, atol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dim, n, r", [(256, 16, 32), (200, 16, 32),
                                       (130, 8, 5), (64, 32, 64)])
def test_kernel_matches_plain_on_card(cuda, dtype, reverse, dim, n, r):
    x = scan_inputs(cuda, dtype, batch=3, L=300, dim=dim, n=n, r=r)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True,
              reverse=reverse)
    got = selective_scan_dtlow(*_args(x), impl="cuda", **kw).float()
    want = selective_scan_dtlow(*_args(x), impl="ref", **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_kernel_without_optionals_on_card(cuda):
    """No bias, no softplus, no D, no gate: dt = dt_low @ dt_w as given,
    kept positive here so the recurrence decays."""
    x = scan_inputs(cuda, torch.float32, dim=160)
    x["dt_low"], x["dt_w"] = x["dt_low"].abs(), 0.1 * x["dt_w"].abs()
    got = selective_scan_cuda(*_args(x)[:6])
    want = selective_scan_dtlow(*_args(x)[:6], impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_kernel_counts_its_launches(cuda):
    x = scan_inputs(cuda, torch.float32)
    before = selective_scan_cuda.launches
    selective_scan_dtlow(*_args(x), reverse=True)
    assert selective_scan_cuda.launches == before + 1


def test_kernel_raises_on_what_it_does_not_take(cuda):
    x = scan_inputs(cuda, torch.float32)
    args = dict(u=x["u"], dt_low=x["dt_low"], dt_w=x["dt_w"], A=x["A"],
                B=x["B"], C=x["C"])
    with pytest.raises(NotImplementedError, match="grouped"):
        selective_scan_cuda(**{**args, "B": x["B"][:, :, None].expand(
            -1, -1, 2, -1)})
    with pytest.raises(TypeError):
        selective_scan_cuda(**{k: v if k == "A" else v.half()
                               for k, v in args.items()})
    with pytest.raises(TypeError):
        selective_scan_cuda(**{**args, "A": x["A"].bfloat16()})
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan_cuda(**{**args, "u": x["u"].transpose(0, 1)
                               .contiguous().transpose(0, 1)})
    with pytest.raises(ValueError, match="shape"):
        selective_scan_cuda(**{**args, "dt_low": x["dt_low"][:, :-1]
                               .contiguous()})
    big = scan_inputs(cuda, torch.float32, n=64)
    with pytest.raises(NotImplementedError, match="N <="):
        selective_scan_cuda(*_args(big)[:6])


# ---------------------------------------------------------------------------
# The training pair: kernel 2 (forward with saved states) and kernel 3
# (backward).  Tolerances relative to each tensor's scale: fp32 1e-4 (exp2
# against exp, other summation orders: the warp sums of dB/dC, the fp32
# products of ddt_low/ddt_w); bf16 outputs 1.6e-2 (one bf16 rounding step
# either way), while the fp32 outputs o and the states keep 1e-4.
# ---------------------------------------------------------------------------

from dimsum_torch.ops.selective_scan import (  # noqa: E402
    TRAIN_CHUNK, selective_scan_bwd, selective_scan_bwd_core_cuda,
    selective_scan_bwd_ref, selective_scan_fwd_train_cuda,
    selective_scan_fwd_train_ref)


def _close(got, want, tol):
    scale = max(want.float().abs().max().item(), 1e-30)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


def _train_kw(x):
    return dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)


def test_inference_kernel_refuses_grad_mode():
    x = scan_inputs("cpu", torch.float32)
    x["u"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        selective_scan_cuda(*_args(x))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_cuda(*_args(x))


def test_cuda_route_refuses_cpu_tensors_in_training():
    x = scan_inputs("cpu", torch.float32)
    x["u"].requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        selective_scan_dtlow(*_args(x), impl="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim, n, r, L", [
    (256, 16, 32, 256), (200, 16, 32, 300), (130, 8, 5, 77),
    (64, 32, 64, 48), (20, 1, 1, 5)])
def test_fwd_train_kernel_matches_plain_on_card(cuda, dtype, dim, n, r, L):
    x = scan_inputs(cuda, dtype, batch=3, L=L, dim=dim, n=n, r=r)
    got = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    want = selective_scan_fwd_train_ref(*_args(x), **_train_kw(x))
    torch.cuda.synchronize()
    assert got[2].shape == (3, -(-L // TRAIN_CHUNK), n, dim)
    _close(got[0], want[0], 1e-4 if dtype == torch.float32 else 1.6e-2)
    _close(got[1], want[1], 1e-4)
    _close(got[2], want[2], 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim, n, r, L", [
    (256, 16, 32, 256), (200, 16, 32, 300), (130, 8, 5, 77),
    (64, 32, 64, 48), (20, 1, 1, 5)])
def test_bwd_kernel_matches_plain_on_card(cuda, dtype, dim, n, r, L):
    x = scan_inputs(cuda, dtype, batch=3, L=L, dim=dim, n=n, r=r)
    _, o, bnd = selective_scan_fwd_train_ref(*_args(x), **_train_kw(x))
    g = torch.randn(x["u"].shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    kw = dict(_train_kw(x), o=o, boundaries=bnd, g=g)
    b0 = selective_scan_bwd_core_cuda.launches
    got = selective_scan_bwd(*_args(x), **kw)
    assert selective_scan_bwd_core_cuda.launches == b0 + 1
    want = selective_scan_bwd_ref(*_args(x), **kw)
    torch.cuda.synchronize()
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")
    for name, a, b in zip(names, got, want):
        low = a.dtype == torch.bfloat16
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _close(a, b, 1.6e-2 if low else 1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_train_route_grads_match_plain_autograd_on_card(cuda, reverse):
    """selective_scan_dtlow on CUDA with grad: kernels 2 and 3, once each,
    against autograd through the plain recurrence."""
    x = scan_inputs(cuda, torch.float32, batch=2, L=96, dim=192, n=16, r=12)
    leaves = [x[k].requires_grad_(True) for k in
              ("u", "dt_low", "dt_w", "A", "B", "C", "D", "z",
               "delta_bias")]
    g = torch.randn(x["u"].shape, device=cuda)

    def grads(impl):
        y = selective_scan_dtlow(*_args(x), **_train_kw(x), reverse=reverse,
                                 impl=impl)
        return torch.autograd.grad(y, leaves, g)

    f0 = selective_scan_fwd_train_cuda.launches
    b0 = selective_scan_bwd_core_cuda.launches
    k0 = selective_scan_cuda.launches
    got = grads("cuda")
    assert selective_scan_fwd_train_cuda.launches == f0 + 1
    assert selective_scan_bwd_core_cuda.launches == b0 + 1
    assert selective_scan_cuda.launches == k0
    want = grads("ref")
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


# ---------------------------------------------------------------------------
# Full-block attention (`csrc/full_attention.cu`) against its plain version.
# q, k and v are slices of one qkv tensor, as the modules give them.
# Tolerances, relative to the output's largest value: fp32 2e-5 (the same
# fp32 products summed in other orders, exp2 against exp); bf16 1.6e-2 (the
# kernel rounds P to bf16 against the running row max, the plain version
# against the final one, and the output rounds to bf16: a few 2^-8 steps).
# ---------------------------------------------------------------------------

from dimsum_torch.ops.full_attention import (  # noqa: E402
    full_attention_ref, full_block_attention, full_block_attention_cuda)


def attn_inputs(device, dtype, B, L, H, Dh, seed=0, logit_scale=1.0):
    """q, k, v (B, L, H, Dh) as channel slices of one (B, L, 3 H Dh)
    projection; q and k scaled by `logit_scale`."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, L, 3, H * Dh, generator=g)
    qkv[:, :, :2] *= logit_scale
    qkv = qkv.reshape(B, L, 3 * H * Dh).to(device, dtype)
    return [qkv[..., i * H * Dh:(i + 1) * H * Dh].reshape(B, L, H, Dh)
            for i in range(3)]


def test_attention_cpu_tensors_take_the_plain_version():
    q, k, v = attn_inputs("cpu", torch.float32, 2, 128, 2, 64)
    torch.testing.assert_close(full_block_attention(q, k, v, 0.125),
                               full_attention_ref(q, k, v, 0.125),
                               rtol=0, atol=0)


def test_attention_kernel_refuses_cpu_tensors():
    q, k, v = attn_inputs("cpu", torch.float32, 1, 128, 1, 64)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        full_block_attention_cuda(q, k, v, 0.125)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        full_block_attention_cuda(q, k, v, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, L, H, Dh", [
    (24, 1024, 16, 64), (24, 1024, 8, 64), (2, 1024, 2, 72),
    (3, 256, 3, 64), (2, 128, 2, 128), (1, 384, 1, 80)])
def test_attention_kernel_matches_plain_on_card(cuda, dtype, B, L, H, Dh):
    q, k, v = attn_inputs(cuda, dtype, B, L, H, Dh, seed=L + Dh)
    with torch.no_grad():
        got = full_block_attention(q, k, v, Dh ** -0.5)
        want = full_attention_ref(q, k, v, Dh ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, L, H, Dh)
    assert torch.isfinite(got).all()
    _close(got, want, 2e-5 if dtype == torch.float32 else 1.6e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_large_logits_on_card(cuda, dtype):
    """Logits of order 1e3 (q and k 40x N(0, 1)): the row max keeps exp
    finite; the softmax is near one-hot, so the output tracks the plain
    version's as closely as at unit logits."""
    q, k, v = attn_inputs(cuda, dtype, 1, 128, 2, 64, seed=2,
                          logit_scale=40.0)
    with torch.no_grad():
        got = full_block_attention(q, k, v, 0.125)
        want = full_attention_ref(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, want, 2e-5 if dtype == torch.float32 else 1.6e-2)


def test_attention_kernel_counts_its_launches(cuda):
    q, k, v = attn_inputs(cuda, torch.bfloat16, 1, 1024, 2, 64)
    before = full_block_attention_cuda.launches
    with torch.no_grad():
        full_block_attention(q, k, v, 0.125)
    assert full_block_attention_cuda.launches == before + 1


def test_attention_kernel_raises_on_what_it_does_not_take(cuda):
    def call(*shape, dtype=torch.bfloat16):
        full_block_attention_cuda(*attn_inputs(cuda, dtype, *shape), 0.1)

    with torch.no_grad():
        for L, Dh in ((1000, 64), (2048, 64), (1024, 56), (1024, 136),
                      (1024, 60)):
            with pytest.raises(NotImplementedError, match="takes"):
                call(1, L, 1, Dh)
        with pytest.raises(TypeError):
            call(1, 128, 1, 64, dtype=torch.float16)
        q, k, v = attn_inputs(cuda, torch.float32, 1, 128, 2, 64)
        with pytest.raises(ValueError, match="contiguous"):
            full_block_attention_cuda(q.transpose(2, 3).contiguous()
                                      .transpose(2, 3), k, v, 0.1)
        with pytest.raises(TypeError):
            full_block_attention_cuda(q, k.bfloat16(), v, 0.1)
        with pytest.raises(ValueError, match="shape"):
            full_block_attention_cuda(q, k[:, :, :1], v, 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_grads_match_plain_autograd_on_card(cuda, dtype):
    """The Function (kernel forward, recomputed plain backward) against
    autograd through the plain version: the same backward, so the
    gradients agree as the forwards do."""
    leaves = [t.detach().requires_grad_(True) for t in
              attn_inputs(cuda, dtype, 2, 256, 2, 64, seed=5)]
    g = torch.randn(leaves[0].shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(6)).to(dtype)
    before = full_block_attention_cuda.launches
    out = full_block_attention(*leaves, 0.125)
    got = torch.autograd.grad(out, leaves, g)
    assert full_block_attention_cuda.launches == before + 1
    want = torch.autograd.grad(full_attention_ref(*leaves, 0.125), leaves, g)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b, 2e-5 if dtype == torch.float32 else 1.6e-2)
