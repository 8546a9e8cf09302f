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
