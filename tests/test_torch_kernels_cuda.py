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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 64])
@pytest.mark.parametrize("n", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("L", [1, 9, 17, 33, 65])
def test_kernel_chunk_and_lane_edges_on_card(cuda, dtype, L, n, r):
    """The kernel's edges: L of one step, below its 16-step chunk and just
    above a multiple of it; N not a multiple of the 4 lanes a channel's
    states are spread over (padded with zero states); r of 1 and the
    largest; a ragged last block of channels."""
    x = scan_inputs(cuda, dtype, batch=2, L=L, dim=40, n=n, r=r)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    got = selective_scan_cuda(*_args(x), **kw).float()
    want = selective_scan_dtlow(*_args(x), impl="ref", **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_softplus_at_large_pre_activations_on_card(cuda, dtype):
    """dt pre-activations near +30 and -30 (half the channels each): the
    kernel's softplus does not overflow and its output stays finite and
    close to the plain version's."""
    x = scan_inputs(cuda, dtype, batch=2, L=70, dim=64)
    x["dt_w"] = 0.01 * x["dt_w"]
    x["delta_bias"] = torch.where(torch.arange(64, device=cuda) % 2 == 0,
                                  30.0, -30.0)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    got = selective_scan_cuda(*_args(x), **kw).float()
    want = selective_scan_dtlow(*_args(x), impl="ref", **kw).float()
    assert torch.isfinite(got).all()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_softplus_branches_give_dt_on_card(cuda, dtype):
    """y equals dt itself, so a softplus that cuts off or errs shows: dt_w
    is zero (dt = softplus(bias)), u = B = C = 1 with N 1, D 0, no gate,
    and A so negative that every step's decay is exactly 0.  The biases
    fall on both sides of exp(-|x|) = 2^-6 (|x| = ln 64 = 4.159), where the
    kernel's log1p switches from lg2 to its series, across the series
    region (|x| 5 to 15), at 0 and at +-30; each channel's dt is held
    to the exact softplus relative to its own size."""
    edge = math.log(64.0)
    pre = torch.cat([torch.linspace(-15.0, 15.0, 61),
                     torch.tensor([edge - 1e-3, edge + 1e-3, -edge + 1e-3,
                                   -edge - 1e-3, 30.0, -30.0, 0.0])])
    dim, L = pre.numel(), 40
    x = scan_inputs(cuda, dtype, batch=2, L=L, dim=dim, n=1, r=1)
    for k in ("u", "B", "C"):
        x[k] = torch.ones_like(x[k])
    x["dt_w"] = torch.zeros_like(x["dt_w"])
    x["A"] = torch.full_like(x["A"], -1e30)
    x["D"] = torch.zeros_like(x["D"])
    got = selective_scan_cuda(*_args(x), delta_bias=pre.to(cuda),
                              delta_softplus=True)
    dt = torch.logaddexp(pre.double(), torch.zeros((), dtype=torch.float64))
    want = dt.to(dtype).to(cuda).expand(2, L, dim)
    # fp32: the file's 1e-4; bf16: one step of the output type (2^-7)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.double(), want.double(), rtol=tol,
                               atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_repeats_bit_for_bit_on_card(cuda, dtype):
    x = scan_inputs(cuda, dtype, batch=3, L=300, dim=200)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    first = selective_scan_cuda(*_args(x), **kw)
    assert torch.equal(first, selective_scan_cuda(*_args(x), **kw))


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
# The reverse entry of the same source (`_scan_body`'s reverse-time case):
# the recurrence from the last step to the first, held to the flip
# composition of the plain scan at the tolerances above.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [256, 1024, 200, 1000])
@pytest.mark.parametrize("n", [16, 8])
@pytest.mark.parametrize("dim, r", [(1024, 32), (2048, 64)])
def test_reverse_entry_matches_plain_on_card(cuda, dtype, L, n, dim, r):
    """L 256 and 1024 (the mixers at 256 and 512 px) and ragged L (the
    ragged chunk is the first the kernel walks), N 16 and 8, at the width
    and rank of the combined block's mixers (1024, r 32) and of linear +
    v2's (2048, r 64: the r <= 64 instantiation)."""
    x = scan_inputs(cuda, dtype, batch=2, L=L, dim=dim, n=n, r=r,
                    seed=L + n)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    before = (selective_scan_cuda.launches,
              selective_scan_cuda.reverse_launches)
    got = selective_scan_cuda(*_args(x), reverse=True, **kw).float()
    assert (selective_scan_cuda.launches,
            selective_scan_cuda.reverse_launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = selective_scan_dtlow(*_args(x), impl="ref", reverse=True,
                                **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [64, 70, 1])
@pytest.mark.parametrize("r", [8, 64])
def test_reverse_entry_is_the_forward_entry_flipped_on_card(cuda, dtype, L,
                                                            r):
    """Each step's arithmetic and each output's sum are the forward
    entry's on the flipped inputs: the same bits; and the reverse entry
    repeats bit for bit."""
    x = scan_inputs(cuda, dtype, batch=3, L=L, dim=200, n=16, r=r)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    got = selective_scan_cuda(*_args(x), reverse=True, **kw)
    assert torch.equal(got, selective_scan_cuda(*_args(x), reverse=True,
                                                **kw))
    flip = {k: (v.flip(1).contiguous() if k in ("u", "dt_low", "B", "C",
                                                 "z") else v)
            for k, v in x.items()}
    want = selective_scan_cuda(*_args(flip), z=flip["z"],
                               delta_bias=x["delta_bias"],
                               delta_softplus=True).flip(1)
    assert torch.equal(got, want)


def test_dtlow_reverse_routes_on_card(cuda):
    """Without a gradient `selective_scan_dtlow(reverse=True)` launches the
    reverse entry once and flips nothing; with one it takes the training
    Function between flips and launches no inference kernel."""
    x = scan_inputs(cuda, torch.float32, dim=128)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True,
              reverse=True)
    fwd, rev = (selective_scan_cuda.launches,
                selective_scan_cuda.reverse_launches)
    with torch.no_grad():
        selective_scan_dtlow(*_args(x), **kw)
    assert (selective_scan_cuda.launches,
            selective_scan_cuda.reverse_launches) == (fwd + 1, rev + 1)
    x["u"].requires_grad_(True)
    train = selective_scan_fwd_train_cuda.launches
    selective_scan_dtlow(*_args(x), **kw).sum().backward()
    assert selective_scan_fwd_train_cuda.launches == train + 1
    assert selective_scan_cuda.launches == fwd + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reversed_block_routes_agree_on_card(cuda, dtype):
    """A reversed combined block (half width 512, L 256) without a
    gradient runs its spatial mixer's reverse on the reverse entry (one
    launch, no flips); forced to the block's flips it launches the
    forward entry only; under a gradient it flips and launches no
    inference kernel.  The three outputs agree within the tolerances
    above."""
    from dimsum_torch.models.blocks import DiMBlockCombined

    torch.manual_seed(0)
    block = DiMBlockCombined(1024, reverse=True, d_cond=1024, dtype=dtype)
    for p in block.parameters():
        p.data.normal_(0.0, 0.05)
    block = block.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x, res = (torch.randn(2, 256, 1024, generator=g, device=cuda)
              for _ in range(2))
    c = torch.randn(2, 1024, generator=g, device=cuda).to(dtype)
    x = x.to(dtype)
    assert block.spatial_mamba.native
    outs = []
    for native in (True, False):
        block.spatial_mamba.native = native
        rev = selective_scan_cuda.reverse_launches
        with torch.no_grad():
            outs.append(block(x, res, c)[0].float())
        assert selective_scan_cuda.reverse_launches == rev + native
    block.spatial_mamba.native = True
    fwd = selective_scan_cuda.launches
    xg = x.clone().requires_grad_(True)
    out = block(xg, res, c)[0]
    out.float().square().sum().backward()
    assert selective_scan_cuda.launches == fwd
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for other in (outs[1], out.detach().float()):
        torch.testing.assert_close(outs[0], other, rtol=tol, atol=tol)


def test_reverse_entry_raises_on_what_it_does_not_take(cuda):
    """No quiet flip: what the forward entry refuses, the reverse one does
    too."""
    x = scan_inputs(cuda, torch.float32)
    with pytest.raises(NotImplementedError, match="grouped"):
        selective_scan_cuda(*_args({**x, "B": x["B"][:, :, None].expand(
            -1, -1, 2, -1)}), reverse=True)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan_cuda(*_args({**x, "u": x["u"].transpose(0, 1)
                                    .contiguous().transpose(0, 1)}),
                            reverse=True)
    big = scan_inputs(cuda, torch.float32, n=64)
    with pytest.raises(NotImplementedError, match="N <="):
        selective_scan_dtlow(*_args(big), impl="cuda", reverse=True)


# ---------------------------------------------------------------------------
# The state entry of the same source (the sequence-parallel scan's local
# passes): a full delta, h0 and the last state.  Tolerances as above for
# the output; the last state is fp32 in both dtypes and is never rounded to
# bf16, so both hold it to 1e-4 of its scale.
# ---------------------------------------------------------------------------

from dimsum_torch.ops.selective_scan import (  # noqa: E402
    selective_scan_state, selective_scan_state_cuda)


def state_inputs(device, dtype, batch=2, L=64, dim=16, n=16, seed=0):
    """scan_inputs with the full delta = dt_low @ dt_w in `dtype` (as the
    SP mixer makes it) and an fp32 h0 (batch, dim, n)."""
    x = scan_inputs(device, dtype, batch=batch, L=L, dim=dim, n=n, r=8,
                    seed=seed)
    x["delta"] = (x.pop("dt_low") @ x.pop("dt_w")).contiguous()
    g = torch.Generator().manual_seed(seed + 1)
    x["h0"] = torch.randn(batch, dim, n, generator=g).to(device)
    return x


def _state_args(x):
    return [x[k] for k in ("u", "delta", "A", "B", "C", "D")]


def test_state_route_refuses_cpu_tensors():
    x = state_inputs("cpu", torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        selective_scan_state_cuda(*_state_args(x))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        selective_scan_state(*_state_args(x), impl="cuda")


def test_state_cpu_tensors_take_the_plain_version():
    x = state_inputs("cpu", torch.float32)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True,
              h0=x["h0"], return_last_state=True)
    got = selective_scan_state(*_state_args(x), **kw)
    want = selective_scan_state(*_state_args(x), impl="ref", **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("L, dim, n", [(256, 256, 16), (300, 200, 16),
                                       (77, 64, 8), (33, 40, 32)])
def test_state_kernel_matches_plain_on_card(cuda, dtype, with_h0, with_last,
                                            L, dim, n):
    """With and without h0 and the last state, N 8 / 16 / 32, L a
    multiple of the 16-step chunk and ragged (the last state then is the
    state at step L - 1: the kernel runs the ragged chunk with dt = 0 past
    the end), a ragged last block of channels."""
    x = state_inputs(cuda, dtype, batch=3, L=L, dim=dim, n=n)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True,
              h0=x["h0"] if with_h0 else None, return_last_state=with_last)
    got = selective_scan_state(*_state_args(x), impl="cuda", **kw)
    want = selective_scan_state(*_state_args(x), impl="ref", **kw)
    if not with_last:
        got, want = (got, None), (want, None)
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    if with_last:
        assert got[1].dtype == torch.float32
        assert got[1].shape == (3, dim, n)
        _close(got[1], want[1], 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [16, 100])
def test_state_kernel_continues_a_scan_on_card(cuda, dtype, split):
    """Two launches, the second seeded with the first's last state, give
    the one-launch scan (L 300, split on and off the chunk grid)."""
    x = state_inputs(cuda, dtype, batch=2, L=300, dim=96)
    kw = dict(D=x["D"], delta_bias=x["delta_bias"], delta_softplus=True)

    def part(sl, **extra):
        return selective_scan_state_cuda(
            x["u"][:, sl].contiguous(), x["delta"][:, sl].contiguous(),
            x["A"], x["B"][:, sl].contiguous(), x["C"][:, sl].contiguous(),
            z=x["z"][:, sl].contiguous(), **kw, **extra)

    whole, last = part(slice(None), return_last_state=True)
    first, mid = part(slice(0, split), return_last_state=True)
    second, end = part(slice(split, None), h0=mid, return_last_state=True)
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    _close(torch.cat([first, second], 1), whole, tol)
    _close(end, last, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_kernel_without_optionals_on_card(cuda, dtype):
    """No bias, no softplus, no D, no gate, delta kept positive."""
    x = state_inputs(cuda, dtype, dim=160)
    x["delta"] = (0.05 * x["delta"].abs()).contiguous()
    got = selective_scan_state(*_state_args(x)[:5], impl="cuda",
                               return_last_state=True)
    want = selective_scan_state(*_state_args(x)[:5], impl="ref",
                                return_last_state=True)
    _close(got[0], want[0], 1e-4 if dtype == torch.float32 else 1.6e-2)
    _close(got[1], want[1], 1e-4)


def test_state_kernel_repeats_and_counts_its_launches(cuda):
    x = state_inputs(cuda, torch.bfloat16, batch=3, L=300, dim=200)
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True,
              h0=x["h0"], return_last_state=True)
    before = selective_scan_state_cuda.launches
    row1 = selective_scan_cuda.launches
    first = selective_scan_state(*_state_args(x), **kw)
    again = selective_scan_state(*_state_args(x), **kw)
    assert selective_scan_state_cuda.launches == before + 2
    assert selective_scan_cuda.launches == row1
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_state_kernel_raises_on_what_it_does_not_take(cuda):
    x = state_inputs(cuda, torch.float32)
    args = dict(u=x["u"], delta=x["delta"], A=x["A"], B=x["B"], C=x["C"])
    with pytest.raises(NotImplementedError, match="grouped"):
        selective_scan_state_cuda(**{**args, "B": x["B"][:, :, None].expand(
            -1, -1, 2, -1)})
    with pytest.raises(TypeError, match="delta"):
        selective_scan_state_cuda(**{**args, "delta": x["delta"].bfloat16()})
    with pytest.raises(TypeError, match="h0"):
        selective_scan_state_cuda(**args, h0=x["h0"].bfloat16())
    with pytest.raises(ValueError, match="h0"):
        selective_scan_state_cuda(**args, h0=x["h0"][:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan_state_cuda(**{**args, "delta": x["delta"].transpose(
            0, 1).contiguous().transpose(0, 1)})
    with pytest.raises(RuntimeError, match="no backward"):
        selective_scan_state_cuda(**{**args, "u": x["u"].requires_grad_()})
    big = state_inputs(cuda, torch.float32, n=64)
    with pytest.raises(NotImplementedError, match="N <="):
        selective_scan_state_cuda(*_state_args(big)[:5])


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
    selective_scan_fwd_train_ref, selective_scan_fwd_train_states_ref)


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


def _fwd_train_matches_plain(x, dtype, batch, L, n, dim):
    f0 = selective_scan_fwd_train_cuda.launches
    got = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    assert selective_scan_fwd_train_cuda.launches == f0 + 1
    want = selective_scan_fwd_train_ref(*_args(x), **_train_kw(x))
    torch.cuda.synchronize()
    assert got[2].shape == (batch, -(-L // TRAIN_CHUNK), n, dim)
    _close(got[0], want[0], 1e-4 if dtype == torch.float32 else 1.6e-2)
    _close(got[1], want[1], 1e-4)
    _close(got[2], want[2], 1e-4)


# the main pass takes groups of 4 chunks (64 steps): ragged L on both sides
# of a chunk and of a group, L < 16, many groups; ragged dims (not a
# multiple of the state pass's 8 channels or the main pass's 32)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim, n, r, L", [
    (256, 16, 32, 256), (200, 16, 32, 300), (130, 8, 5, 77),
    (64, 32, 64, 48), (20, 1, 1, 5),
    (256, 16, 32, 63), (256, 16, 32, 64), (256, 16, 32, 65),
    (96, 16, 32, 129), (100, 8, 16, 1), (37, 16, 32, 15), (1000, 16, 32, 17),
    (256, 16, 32, 1000), (72, 32, 64, 191)])
def test_fwd_train_kernel_matches_plain_on_card(cuda, dtype, dim, n, r, L):
    x = scan_inputs(cuda, dtype, batch=3, L=L, dim=dim, n=n, r=r)
    _fwd_train_matches_plain(x, dtype, 3, L, n, dim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 16, 70, 1024])
def test_fwd_train_kernel_batch_one_on_card(cuda, dtype, L):
    x = scan_inputs(cuda, dtype, batch=1, L=L, dim=256, n=16, r=32)
    _fwd_train_matches_plain(x, dtype, 1, L, 16, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim, n, r, L", [
    (256, 16, 32, 1024), (200, 8, 5, 300), (64, 32, 64, 17)])
def test_fwd_train_states_match_plain_state_pass_on_card(cuda, dtype, dim,
                                                         n, r, L):
    """The state pass's boundaries against its plain version (alpha and
    beta of every chunk, chained from the left) on the same inputs."""
    x = scan_inputs(cuda, dtype, batch=2, L=L, dim=dim, n=n, r=r)
    _, _, bnd = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    want = selective_scan_fwd_train_states_ref(
        *_args(x)[:5], delta_bias=x["delta_bias"], delta_softplus=True)
    torch.cuda.synchronize()
    assert not bnd[:, 0].any()
    _close(bnd, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_train_kernel_repeats_bit_for_bit_on_card(cuda, dtype):
    """At the 512-px training shape (4 x 1024 tokens, dim 1024, N 16, r
    32): no float atomics, so two calls give the same bits."""
    x = scan_inputs(cuda, dtype, batch=4, L=1024, dim=1024, n=16, r=32)
    first = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    second = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [256, 300])
def test_bwd_kernel_from_fwd_train_kernel_states_on_card(cuda, dtype, L):
    """Kernel 3 run on kernel 2's o and states gives the plain backward's
    gradients from the plain forward's o and states."""
    x = scan_inputs(cuda, dtype, batch=2, L=L, dim=192, n=16, r=32)
    _, o, bnd = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    _, o_ref, bnd_ref = selective_scan_fwd_train_ref(*_args(x),
                                                     **_train_kw(x))
    g = torch.randn(x["u"].shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3)).to(dtype)
    got = selective_scan_bwd(*_args(x), **_train_kw(x), o=o, boundaries=bnd,
                             g=g)
    want = selective_scan_bwd_ref(*_args(x), **_train_kw(x), o=o_ref,
                                  boundaries=bnd_ref, g=g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, 1.6e-2 if a.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim, n, r, L", [
    (256, 16, 32, 256), (200, 16, 32, 300), (130, 8, 5, 77),
    (64, 32, 64, 48), (20, 1, 1, 5),
    # many chunks in parallel, a chunk exactly, one step past it, ragged L
    # over many chunks; N 32 (the states' a_t computed again) at r 64
    (256, 16, 32, 1024), (256, 16, 32, 16), (200, 16, 32, 17),
    (130, 8, 5, 1000), (96, 32, 64, 300)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_repeats_bit_for_bit_on_card(cuda, dtype):
    """At the 512-px training shape (4 x 1024 tokens, dim 1024, N 16, r
    32): no float atomics, so two calls give the same bits."""
    x = scan_inputs(cuda, dtype, batch=4, L=1024, dim=1024, n=16, r=32)
    _, _, bnd = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    go = torch.randn(x["u"].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2))
    core = (*_args(x)[:6], x["delta_bias"], True, go, bnd)
    first = selective_scan_bwd_core_cuda(*core)
    second = selective_scan_bwd_core_cuda(*core)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


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
# Full-block attention against its plain version: bf16 at Dh 64 through
# `csrc/full_attention_sm90.cu` (TMA + wgmma), fp32 at Dh 64 through
# `csrc/full_attention_f32.cu` (S on the FP32 pipe, P V as three TF32
# products), everything else through `csrc/full_attention.cu`
# (`attention_kernel` names the kernel).  q, k and v are slices of one qkv
# tensor, as the modules give them.
# Tolerances, relative to the output's largest value: fp32 2e-5 (the same
# fp32 products summed in other orders, exp2 against exp); bf16 1.6e-2 (the
# kernel rounds P to bf16 against the running row max, the plain version
# against the final one, and the output rounds to bf16: a few 2^-8 steps).
# ---------------------------------------------------------------------------

from dimsum_torch.ops import full_attention as attention_ops  # noqa: E402
from dimsum_torch.ops.full_attention import (  # noqa: E402
    attention_kernel, full_attention_ref, full_block_attention,
    full_block_attention_cuda)

ATTENTION_KERNELS = ("full_attention_sm90", "full_attention_f32",
                     "full_attention_first")


def attn_counts():
    return {n: getattr(attention_ops, n).launches for n in ATTENTION_KERNELS}


def assert_one_launch_of(name, before):
    """Exactly one launch since `before` (an `attn_counts()`), through the
    kernel `name` and no other."""
    after = attn_counts()
    assert {n: after[n] - before[n] for n in ATTENTION_KERNELS} == {
        n: int(n == name) for n in ATTENTION_KERNELS}


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
    """Bit for bit, both sides under one pinned thread count: with
    PyTorch's default (a thread a core), the CPU matmul summed the same
    products in other orders from one call to the next."""
    q, k, v = attn_inputs("cpu", torch.float32, 2, 128, 2, 64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.testing.assert_close(full_block_attention(q, k, v, 0.125),
                                   full_attention_ref(q, k, v, 0.125),
                                   rtol=0, atol=0)
    finally:
        torch.set_num_threads(threads)


def _tf32(x, nearest=True):
    """fp32 cut to TF32 (10 mantissa bits) by bit masking: to nearest, ties
    away from zero, as the kernel rounds the big part; or truncated, as the
    tensor cores read the small part."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000 if nearest else bits) & -0x2000).view(torch.float32)


def _three_tf32(a, b):
    """a @ b as three TF32 products, small terms first, fp32 sums."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small = _tf32(a - a_big, nearest=False)
    b_small = _tf32(b - b_big, nearest=False)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def f32_kernel_emulated(q, k, v, sm_scale, split_s=False):
    """The arithmetic of `csrc/full_attention_f32.cu` in plain PyTorch:
    q * scale rounded to fp32; per 64-key tile S = q k^T in fp32 (the plain
    version's product), the running row max, P = exp2((S - max) log2 e),
    the rescale, and O += P V as three TF32 products; O / the row sum.
    `split_s` takes S as three TF32 products too, the design the kernel
    does not use."""
    log2e = 1.4426950408889634
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (qs, k, v))
    m = torch.full(qt.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qt)
    for j0 in range(0, qt.shape[2], 64):
        kj, vj = kt[:, :, j0:j0 + 64].transpose(-1, -2), vt[:, :, j0:j0 + 64]
        s = _three_tf32(qt, kj) if split_s else qt @ kj
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((s - m_new) * log2e)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _three_tf32(p, vj)
        m = m_new
    return (o / l).transpose(1, 2)


# (B, L, H, seed, logit scale, softmax scale): the card tests' unit-logit
# and 40x-logit inputs
F32_EMULATION_CASES = [(1, 128, 2, 2, 40.0, 0.125), (2, 1024, 2, 3, 40.0, 0.125),
                       (2, 256, 3, 259, 1.0, 0.1), (2, 1024, 1, 1025, 1.0, 0.125)]


@pytest.mark.parametrize("B, L, H, seed, logit_scale, scale",
                         F32_EMULATION_CASES)
def test_f32_kernel_arithmetic_holds_the_tolerance(B, L, H, seed,
                                                    logit_scale, scale):
    """The fp32 kernel's arithmetic, emulated on the CPU, against the plain
    version at the card tests' fp32 tolerance, 2e-5 of the output's
    largest value, large logits included."""
    q, k, v = attn_inputs("cpu", torch.float32, B, L, H, 64, seed=seed,
                          logit_scale=logit_scale)
    _close(f32_kernel_emulated(q, k, v, scale),
           full_attention_ref(q, k, v, scale), 2e-5)


@pytest.mark.parametrize("B, L, H, seed, logit_scale", [
    (2, 1024, 2, 72, 40.0), (2, 256, 3, 73, 1.0)])
def test_f32_kernel_arithmetic_holds_the_tolerance_at_dh72(B, L, H, seed,
                                                            logit_scale):
    """As above at Dh 72 (DiT-XL/2's and DiM-XL/2's heads) and its scale,
    72^-1/2: the kernel's 9 n8 tiles of P V a warp change no sum."""
    q, k, v = attn_inputs("cpu", torch.float32, B, L, H, 72, seed=seed,
                          logit_scale=logit_scale)
    _close(f32_kernel_emulated(q, k, v, 72 ** -0.5),
           full_attention_ref(q, k, v, 72 ** -0.5), 2e-5)


def test_f32_kernel_keeps_s_off_the_tensor_cores():
    """Why S is summed in fp32: as three TF32 products (~7e-7 of each term
    against fp32's ~6e-8), the logits of 40x inputs (~1e3) move by ~1e-3,
    and where two keys of a row nearly tie the output misses the fp32
    tolerance by far."""
    q, k, v = attn_inputs("cpu", torch.float32, 2, 1024, 2, 64, seed=3,
                          logit_scale=40.0)
    want = full_attention_ref(q, k, v, 0.125)
    err = (f32_kernel_emulated(q, k, v, 0.125, split_s=True) - want).abs()
    assert err.max() > 5 * 2e-5 * want.abs().max()


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
    before = attn_counts()
    with torch.no_grad():
        got = full_block_attention(q, k, v, Dh ** -0.5)
        want = full_attention_ref(q, k, v, Dh ** -0.5)
    torch.cuda.synchronize()
    assert_one_launch_of(attention_kernel(dtype, Dh), before)
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
    before = attn_counts()
    with torch.no_grad():
        got = full_block_attention(q, k, v, 0.125)
        want = full_attention_ref(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert_one_launch_of(attention_kernel(dtype, 64), before)
    assert torch.isfinite(got).all()
    _close(got, want, 2e-5 if dtype == torch.float32 else 1.6e-2)


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 1.6e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("L", [128, 256, 384, 1024])
@pytest.mark.parametrize("scale", [0.125, 0.1])
def test_sm90_attention_matches_plain_on_card(cuda, dtype, H, L, scale):
    """Dh 64 through its own kernel (bf16: TMA + wgmma, whose K/V ring
    wraps differently at 2, 4, 6 and 16 tiles of 64 keys; fp32: one K and
    one V buffer, 2 to 16 tiles); a power-of-two scale (folded into the
    exponent in bf16) and another (applied to q first)."""
    q, k, v = attn_inputs(cuda, dtype, 2, L, H, 64, seed=L + H)
    before = attn_counts()
    with torch.no_grad():
        got = full_block_attention(q, k, v, scale)
    assert_one_launch_of(attention_kernel(dtype, 64), before)
    want = full_attention_ref(q, k, v, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, H, Dh", [
    (2, 2, 64),
    (8, 16, 72),  # DiT-XL/2 and DiM-XL/2's DiT block, 8 CFG rows
    (8, 8, 72)])  # DiM-XL/2's cross fusion
def test_sm90_attention_large_logits_at_L1024_on_card(cuda, dtype, B, H, Dh):
    """Logits of order 1e3 over 16 key tiles: the running max grows from
    tile to tile and the output is rescaled each time.  The softmax is
    near one-hot, where a row's two largest logits may nearly tie, so fp32
    holds 2e-5 only if S carries the plain product's bits."""
    q, k, v = attn_inputs(cuda, dtype, B, 1024, H, Dh, seed=3,
                          logit_scale=40.0)
    before = attn_counts()
    with torch.no_grad():
        got = full_block_attention(q, k, v, Dh ** -0.5)
    assert_one_launch_of(attention_kernel(dtype, Dh), before)
    want = full_attention_ref(q, k, v, Dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Dh", [64, 72])
def test_sm90_attention_reads_cross_fusion_slices_on_card(cuda, dtype, Dh):
    """q from one projection and k, v from another, as the cross fusion
    pairs q1 with k2 and v2 (8 heads: DiM-L/2's and, at Dh 72,
    DiM-XL/2's): other base pointers and other row strides (3 H Dh and,
    here, 5 H Dh)."""
    B, L, H = 3, 1024, 8
    q1 = attn_inputs(cuda, dtype, B, L, H, Dh, seed=11)[0]
    g = torch.Generator().manual_seed(12)
    wide = torch.randn(B, L, 5 * H * Dh, generator=g).to(cuda, dtype)
    k2 = wide[..., 2 * H * Dh:3 * H * Dh].reshape(B, L, H, Dh)
    v2 = wide[..., 4 * H * Dh:].reshape(B, L, H, Dh)
    assert q1.stride(1) == 3 * H * Dh and k2.stride(1) == 5 * H * Dh
    before = attn_counts()
    with torch.no_grad():
        got = full_block_attention(q1, k2, v2, Dh ** -0.5)
    assert_one_launch_of(attention_kernel(dtype, Dh), before)
    want = full_attention_ref(q1, k2, v2, Dh ** -0.5)
    torch.cuda.synchronize()
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, H, Dh", [(4, 4, 64), (8, 16, 72)])
def test_sm90_attention_repeats_bit_for_bit_on_card(cuda, dtype, B, H, Dh):
    q, k, v = attn_inputs(cuda, dtype, B, 1024, H, Dh, seed=13)
    with torch.no_grad():
        a = full_block_attention(q, k, v, Dh ** -0.5)
        b = full_block_attention(q, k, v, Dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Dh", [80, 128])
def test_attention_other_cases_keep_the_first_kernel_on_card(cuda, dtype,
                                                             Dh):
    """bf16 and fp32 at Dh 80-128 (no model of the zoo) go to
    `csrc/full_attention.cu`."""
    q, k, v = attn_inputs(cuda, dtype, 2, 1024, 2, Dh, seed=Dh)
    before, every = attn_counts(), full_block_attention_cuda.launches
    with torch.no_grad():
        got = full_block_attention(q, k, v, Dh ** -0.5)
    assert_one_launch_of("full_attention_first", before)
    assert full_block_attention_cuda.launches == every + 1
    want = full_attention_ref(q, k, v, Dh ** -0.5)
    torch.cuda.synchronize()
    _close(got, want, 2e-5 if dtype == torch.float32 else 1.6e-2)


# ---------------------------------------------------------------------------
# Dh 72 (every 1152-wide model at 512 px) through the Hopper redesigns: bf16
# on TMA + wgmma with each row in a 128-byte-swizzled head (columns 0-63)
# and a 32-byte-swizzled tail (64-79, TMA's zero fill past 72); fp32 on the
# FP32 pipe at a 76-float shared row stride, 9 n8 tiles of P V a warp.
# The large-logit, cross-fusion and repeat tests above take Dh 72 too.
# ---------------------------------------------------------------------------

DH72_KERNELS = {torch.bfloat16: "full_attention_sm90",
                torch.float32: "full_attention_f32"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, L, H", [
    (8, 1024, 16),   # DiT-XL/2 and DiM-XL/2's DiT block, 8 CFG rows
    (8, 1024, 8),    # DiM-XL/2's cross fusion (8 heads on a 576-wide half)
    (2, 128, 3), (3, 256, 2), (1, 384, 1)])
def test_dh72_redesign_matches_plain_on_card(cuda, dtype, B, L, H):
    q, k, v = attn_inputs(cuda, dtype, B, L, H, 72, seed=L + H)
    assert attention_kernel(dtype, 72) == DH72_KERNELS[dtype]
    before = attn_counts()
    with torch.no_grad():
        got = full_block_attention(q, k, v, 72 ** -0.5)
    assert_one_launch_of(DH72_KERNELS[dtype], before)
    want = full_attention_ref(q, k, v, 72 ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, L, H, 72)
    assert torch.isfinite(got).all()
    _close(got, want, _tol(dtype))


def _fma_chain(qt, kt):
    """S = qt kt^T as one fp32 FMA chain a (row, key) over d from zero,
    emulated exactly in fp64: each product is exact there; the sum with
    the running value is rounded to fp64 and its rounding error kept
    (TwoSum), and the fp32 rounding takes that error's sign where the fp64
    sum lies on a midpoint between two fp32 values."""
    s = torch.zeros(qt.shape[:-1] + (kt.shape[-2],), device=qt.device)
    for d in range(qt.shape[-1]):
        prod = qt[..., d:d + 1].double() * kt[..., d].unsqueeze(-2).double()
        acc = s.double()
        tot = prod + acc
        t = tot - prod
        err = (prod - (tot - t)) + (acc - t)
        near = tot.float()
        toward = torch.nextafter(near, torch.where(
            err > 0, torch.tensor(math.inf, device=s.device),
            torch.tensor(-math.inf, device=s.device)))
        mid = (near.double() + toward.double()) * 0.5
        s = torch.where((err != 0) & (tot == mid), toward, near)
    return s


@pytest.mark.parametrize("B, H, Dh", [(8, 16, 72), (8, 8, 72), (8, 16, 64)])
def test_fp32_product_is_one_fma_chain_on_card(cuda, B, H, Dh):
    """The fp32 kernel sums S as one FMA chain over d = 0 ... Dh - 1: on
    the card that is the plain version's product (`torch.matmul` on fp32,
    TF32 off) bit for bit, at Dh 72 as at Dh 64."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q, k, _ = attn_inputs(cuda, torch.float32, B, 1024, H, Dh,
                              seed=Dh + H)
        qs = q * torch.tensor(Dh ** -0.5, dtype=q.dtype)
        qt, kt = (t.transpose(1, 2).float() for t in (qs, k))
        want = torch.matmul(qt, kt.transpose(-1, -2))
        got = _fma_chain(qt, kt)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert torch.equal(got, want)


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
        # the redesigns are built for Dh 64 and 72 alone; no fallback
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attn_inputs(cuda, dtype, 1, 128, 1, 80)
            for fn in (attention_ops.full_attention_sm90,
                       attention_ops.full_attention_f32):
                with pytest.raises(NotImplementedError, match="built for"):
                    fn(q, k, v, torch.empty_like(q), 0.1)
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


# ---------------------------------------------------------------------------
# The fused-kernel configuration: add + norm (`csrc/add_norm.cu`), norm +
# modulate (`csrc/norm_modulate.cu`) and conv + x_proj
# (`csrc/conv_xproj.cu`), each against its plain version.  Tolerances
# relative to each tensor's largest value: fp32 1e-5 (rsqrt, exp and
# summation order); outputs stored in bf16 1.6e-2 (one rounding step either
# way); x_dbl from bf16 inputs 1e-2 (exact products summed in another
# order, and an x_conv entry that rounds to the neighbouring bf16 value
# moves it by 2^-8 of that product).
# ---------------------------------------------------------------------------

from dimsum_torch.ops.conv_xproj import (  # noqa: E402
    conv_xproj, conv_xproj_cuda, conv_xproj_ref)
from dimsum_torch.ops.norms import (  # noqa: E402
    add_norm_cuda, add_norm_ref, fused_add_norm, norm_modulate,
    norm_modulate_cuda, norm_modulate_ref)

# (has_branch, has_gate, has_res, has_mod, is_rms, has_w): the call sites
NORM_CASES = [
    (True, True, False, True, True, True),    # norm_2
    (True, False, False, True, True, True),   # gate-less fused add
    (False, False, True, False, True, True),  # plain add + norm
    (True, True, False, True, False, False),  # DiT second LN
    (False, False, False, True, False, False),  # DiT first LN / FinalLayer
    (True, True, True, False, True, True),    # deferred top (pending tail)
    (True, True, True, True, False, True),    # everything, LayerNorm + bias
]


def norm_inputs(device, dtype, B=3, L=40, D=256, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return s * torch.randn(*shape, generator=g)

    x = dict(x=r(B, L, D), branch=r(B, L, D), residual=r(B, L, D),
             gate=r(B, D, s=0.5), shift=r(B, D, s=0.3), scale=r(B, D, s=0.3),
             weight=1 + r(D, s=0.1), bias=r(D, s=0.1))
    fp32 = ("residual", "weight", "bias")
    return {k: v.to(device, torch.float32 if k in fp32 else dtype)
            for k, v in x.items()}


def norm_kwargs(v, case):
    has_branch, has_gate, has_res, has_mod, is_rms, has_w = case
    return dict(weight=v["weight"] if has_w else None,
                bias=v["bias"] if has_w and not is_rms else None,
                branch=v["branch"] if has_branch else None,
                gate=v["gate"] if has_gate else None,
                residual=v["residual"] if has_res else None,
                shift=v["shift"] if has_mod else None,
                scale=v["scale"] if has_mod else None,
                eps=1e-5 if is_rms else 1e-6, is_rms=is_rms,
                total_dtype=torch.float32 if has_res else None)


def _low(t):
    return 1.6e-2 if t.dtype == torch.bfloat16 else 1e-5


def test_fused_kernels_refuse_cpu_tensors():
    v = norm_inputs("cpu", torch.float32)
    D = v["x"].shape[-1]
    x2, r2 = v["x"].reshape(-1, D), v["residual"].reshape(-1, D)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        add_norm_cuda(x2, r2, v["weight"])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        norm_modulate_cuda(v["x"], v["weight"], shift=v["shift"],
                           scale=v["scale"])
    w = torch.randn(36, D)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        conv_xproj_cuda(v["x"], torch.randn(D, 4), torch.randn(D), w)
    x2.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        add_norm_cuda(x2, r2, v["weight"])
    v["x"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        norm_modulate_cuda(v["x"], v["weight"])
    with pytest.raises(RuntimeError, match="no backward"):
        conv_xproj_cuda(v["x"], torch.randn(D, 4), torch.randn(D), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", NORM_CASES)
@pytest.mark.parametrize("B, L, D", [
    (3, 40, 128), (3, 40, 1152), (3, 40, 4096),
    # the row runs: fewer rows than blocks; runs that differ by one row
    # (bf16 at D 1152: the last 16-byte chunk on half the lanes); more
    # batches than the card holds blocks; the 512-px shape
    (1, 8, 1024), (2, 1000, 1152), (600, 8, 256), (24, 1024, 1024)])
def test_norm_modulate_kernel_matches_plain_on_card(cuda, dtype, case, B, L,
                                                    D):
    v = norm_inputs(cuda, dtype, B=B, L=L, D=D, seed=D)
    kw = norm_kwargs(v, case)
    before = norm_modulate_cuda.launches
    out, tot = norm_modulate_cuda(v["x"], **kw)
    assert norm_modulate_cuda.launches == before + 1
    want_out, want_tot = norm_modulate_ref(v["x"], **kw)
    torch.cuda.synchronize()
    assert out.dtype == want_out.dtype and tot.dtype == want_tot.dtype
    _close(out, want_out, _low(out))
    _close(tot, want_tot, _low(tot))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in NORM_CASES if c[2]])
@pytest.mark.parametrize("B, L, D", [(3, 40, 1152), (24, 256, 1024)])
def test_norm_modulate_kernel_fp32_total_bit_for_bit_on_card(cuda, dtype,
                                                             case, B, L, D):
    """With a residual the total is fp32, each product and sum rounded
    once in the plain version's order: the same bits."""
    v = norm_inputs(cuda, dtype, B=B, L=L, D=D, seed=L)
    kw = norm_kwargs(v, case)
    _, tot = norm_modulate_cuda(v["x"], **kw)
    _, want = norm_modulate_ref(v["x"], **kw)
    torch.cuda.synchronize()
    assert tot.dtype == want.dtype == torch.float32
    torch.testing.assert_close(tot, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (True, True, False, True, False, True),   # linear/raw/window norm_2
    (True, False, False, True, False, True)])  # combined norm_2, LayerNorm
@pytest.mark.parametrize("B, L", [(24, 256), (3, 40)])
def test_norm_modulate_kernel_layernorm_sites_on_card(cuda, dtype, case, B,
                                                      L):
    """The LayerNorm-with-bias sites of the other block types at DiM-L/2's
    width: norm_2 after the gated mixer, and the combined block's norm_2."""
    v = norm_inputs(cuda, dtype, B=B, L=L, D=1024, seed=L)
    kw = norm_kwargs(v, case)
    assert kw["bias"] is not None and not kw["is_rms"]
    out, tot = norm_modulate_cuda(v["x"], **{**kw, "eps": 1e-5})
    want_out, want_tot = norm_modulate_ref(v["x"], **{**kw, "eps": 1e-5})
    torch.cuda.synchronize()
    _close(out, want_out, _low(out))
    _close(tot, want_tot, _low(tot))


def test_norm_modulate_kernel_refuses_rows_off_16_bytes(cuda):
    """The kernel copies rows in 16-byte units: a bf16 x that lies 8 bytes
    off is refused (it passes the 4-value alignment of every operand)."""
    v = norm_inputs(cuda, torch.bfloat16, B=2, L=8, D=128)
    flat = torch.zeros(2 * 8 * 128 + 4, device=cuda, dtype=torch.bfloat16)
    x = flat[4:].view(2, 8, 128)
    x.copy_(v["x"])
    with torch.no_grad(), pytest.raises(ValueError, match="16 bytes"):
        norm_modulate_cuda(x, v["weight"], branch=v["branch"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_modulate_kernel_reads_adaln_chunks_in_place(cuda, dtype):
    """gate, shift and scale as the blocks give them: chunks of one adaLN
    projection, rows 3 D apart."""
    v = norm_inputs(cuda, dtype, B=3, L=40, D=256, seed=11)
    g = torch.Generator().manual_seed(12)
    shift, scale, gate = (0.3 * torch.randn(3, 3 * 256, generator=g)).to(
        cuda, dtype).chunk(3, -1)
    assert not gate.is_contiguous() and gate.stride(0) == 3 * 256
    kw = dict(weight=v["weight"], branch=v["branch"], gate=gate,
              shift=shift, scale=scale)
    got = norm_modulate_cuda(v["x"], **kw)
    want = norm_modulate_ref(v["x"], **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b, _low(a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("is_rms", [True, False])
@pytest.mark.parametrize("rows, D", [(120, 128), (6144, 1024), (24, 4096),
                                     (5, 1152)])
def test_add_norm_kernel_matches_plain_on_card(cuda, dtype, is_rms, rows, D):
    g = torch.Generator().manual_seed(rows + D)
    x2 = torch.randn(rows, D, generator=g).to(cuda, dtype)
    r2 = torch.randn(rows, D, generator=g).to(cuda)
    w = (1 + 0.1 * torch.randn(D, generator=g)).to(cuda)
    b = None if is_rms else (0.1 * torch.randn(D, generator=g)).to(cuda)
    before = add_norm_cuda.launches
    out, tot = add_norm_cuda(x2, r2, w, b, 1e-5, is_rms)
    assert add_norm_cuda.launches == before + 1
    want_out, want_tot = add_norm_ref(x2, r2, w, b, 1e-5, is_rms, dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and tot.dtype == torch.float32
    _close(out, want_out, _low(out))
    torch.testing.assert_close(tot, want_tot, rtol=0, atol=0)


def conv_inputs(device, dtype, B, L, D, W, R, seed=0, strided=False):
    """x (B, L, D), as the first half of a (B, L, 2 D) projection when
    `strided`; conv_w (D, W), conv_b (D,) fp32; w_xp (R, D) fp32."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn(B, L, 2 * D if strided else D, generator=g)
    x = xz.to(device, dtype)[..., :D]
    return (x, (0.3 * torch.randn(D, W, generator=g)).to(device),
            (0.1 * torch.randn(D, generator=g)).to(device),
            (torch.randn(R, D, generator=g) / math.sqrt(D)).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B, L, D, W, R, strided", [
    (2, 256, 1024, 4, 64, True), (2, 256, 1152, 4, 68, True),
    (3, 100, 128, 4, 36, False), (1, 33, 192, 3, 100, True),
    (2, 7, 64, 8, 8, False), (1, 1024, 256, 4, 200, False),
    # the bf16 route's edges: L one token past four 16-token units, ragged
    # L, L one past a unit; more units than the card's warps take at once;
    # the widest R (eight 72-column passes); R that needs padding, on D an
    # odd multiple of 64 (an odd number of chunks for the warp pair to
    # split); W 1 and W 8
    (2, 65, 256, 4, 64, True), (2, 127, 256, 4, 64, True),
    (3, 17, 128, 4, 64, False), (24, 1024, 1024, 4, 64, True),
    (2, 64, 256, 4, 512, False), (2, 80, 192, 4, 68, True),
    (2, 100, 256, 4, 200, True), (2, 50, 128, 1, 64, True),
    (2, 70, 128, 8, 64, True),
    # the taps in shared memory at W 8 beside 64-row w_xp tiles, and read
    # from conv_w where they do not fit beside 72-row tiles
    (2, 40, 1024, 8, 64, True), (2, 70, 1152, 8, 68, True)])
def test_conv_xproj_kernel_matches_plain_on_card(cuda, dtype, reverse, B, L,
                                                 D, W, R, strided):
    x, cw, cb, w = conv_inputs(cuda, dtype, B, L, D, W, R, seed=L + R,
                               strided=strided)
    assert x.is_contiguous() != strided
    before = conv_xproj_cuda.launches
    got_c, got_d = conv_xproj_cuda(x, cw, cb, w, reverse)
    assert conv_xproj_cuda.launches == before + 1
    want_c, want_d = conv_xproj_ref(x, cw, cb, w, reverse)
    torch.cuda.synchronize()
    assert got_c.dtype == dtype and got_d.dtype == torch.float32
    assert got_d.shape == (B, L, R)
    _close(got_c, want_c, _low(got_c))
    _close(got_d, want_d, 1e-2 if dtype == torch.bfloat16 else 1e-5)


def test_conv_xproj_kernel_without_bias_repeats_bit_for_bit(cuda):
    x, cw, _, w = conv_inputs(cuda, torch.bfloat16, 2, 64, 256, 4, 64)
    a = conv_xproj_cuda(x, cw, None, w)
    b = conv_xproj_cuda(x, cw, None, w)
    want = conv_xproj_ref(x, cw, None, w)
    for got, again, ref, tol in zip(a, b, want, (1.6e-2, 1e-2)):
        assert torch.equal(got, again)
        _close(got, ref, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_conv_xproj_kernel_without_bias_matches_plain_on_card(cuda, dtype,
                                                              reverse):
    x, cw, _, w = conv_inputs(cuda, dtype, 2, 97, 192, 4, 68, seed=3,
                              strided=True)
    got_c, got_d = conv_xproj_cuda(x, cw, None, w, reverse)
    want_c, want_d = conv_xproj_ref(x, cw, None, w, reverse)
    torch.cuda.synchronize()
    _close(got_c, want_c, _low(got_c))
    _close(got_d, want_d, 1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_conv_xproj_kernel_with_bias_repeats_bit_for_bit_at_mixer_shape(
        cuda, reverse):
    x, cw, cb, w = conv_inputs(cuda, torch.bfloat16, 24, 256, 1024, 4, 64,
                               seed=5, strided=True)
    a = conv_xproj_cuda(x, cw, cb, w, reverse)
    b = conv_xproj_cuda(x, cw, cb, w, reverse)
    want = conv_xproj_ref(x, cw, cb, w, reverse)
    for got, again, ref, tol in zip(a, b, want, (1.6e-2, 1e-2)):
        assert torch.equal(got, again)
        _close(got, ref, tol)


def test_conv_xproj_kernel_takes_x_tma_cannot_read_on_card(cuda):
    """A bf16 x at an odd element offset, or with a row stride that is no
    multiple of 8, is copied before the kernel reads it."""
    g = torch.Generator().manual_seed(9)
    xz = torch.randn(2, 40, 2 * 128 + 4, generator=g).to(cuda, torch.bfloat16)
    _, cw, cb, w = conv_inputs(cuda, torch.bfloat16, 2, 40, 128, 4, 64)
    for x in (xz[..., 1:129], xz[..., :128]):
        got_c, got_d = conv_xproj_cuda(x, cw, cb, w)
        want_c, want_d = conv_xproj_ref(x, cw, cb, w)
        torch.cuda.synchronize()
        _close(got_c, want_c, 1.6e-2)
        _close(got_d, want_d, 1e-2)


def test_conv_xproj_tma_readable_checks_address_and_strides():
    from dimsum_torch.ops.conv_xproj import _tma_readable

    xz = torch.zeros(2, 40, 2 * 128 + 8, dtype=torch.bfloat16)
    assert _tma_readable(xz[..., :128])
    assert _tma_readable(xz[..., 8:136])
    assert not _tma_readable(xz[..., 1:129])
    assert not _tma_readable(torch.zeros(2, 40, 260,
                                         dtype=torch.bfloat16)[..., :128])


def test_fused_kernels_raise_on_what_they_do_not_take(cuda):
    v = norm_inputs(cuda, torch.float32, D=256)
    x, res = v["x"], v["residual"]
    x2, r2 = x.reshape(-1, 256), res.reshape(-1, 256)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="D % 128"):
            add_norm_cuda(x2[:, :200].contiguous(), r2[:, :200].contiguous(),
                          v["weight"][:200].contiguous())
        with pytest.raises(TypeError):
            add_norm_cuda(x2.half(), r2, v["weight"])
        with pytest.raises(TypeError):
            add_norm_cuda(x2, r2.bfloat16(), v["weight"])
        with pytest.raises(ValueError, match="contiguous"):
            add_norm_cuda(x2.t().contiguous().t(), r2, v["weight"])
        with pytest.raises(NotImplementedError, match="D % 128"):
            norm_modulate_cuda(torch.zeros(2, 8, 4224, device=cuda))
        with pytest.raises(TypeError, match="total_dtype"):
            norm_modulate_cuda(x, total_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="gate needs a branch"):
            norm_modulate_cuda(x, gate=v["gate"])
        with pytest.raises(ValueError, match="together"):
            norm_modulate_cuda(x, shift=v["shift"])
        with pytest.raises(TypeError):
            norm_modulate_cuda(x, shift=v["shift"].bfloat16(),
                               scale=v["scale"])
        with pytest.raises(ValueError, match="shape"):
            norm_modulate_cuda(x, branch=v["branch"][:, :-1].contiguous())
        with pytest.raises(ValueError, match="aligned"):  # rows 257 apart
            norm_modulate_cuda(x, shift=torch.zeros(3, 257, device=cuda)
                               [:, 1:], scale=v["scale"])
        xc, cw, cb, w = conv_inputs(cuda, torch.float32, 2, 16, 96, 4, 8)
        with pytest.raises(NotImplementedError, match="D % 64"):
            conv_xproj_cuda(xc, cw, cb, w)
        xc, cw, cb, w = conv_inputs(cuda, torch.float32, 2, 16, 128, 9, 8)
        with pytest.raises(NotImplementedError, match="W <="):
            conv_xproj_cuda(xc, cw, cb, w)
        xc, cw, cb, w = conv_inputs(cuda, torch.float32, 2, 16, 128, 4, 8)
        with pytest.raises(ValueError, match="channels"):
            conv_xproj_cuda(xc.transpose(1, 2).contiguous().transpose(1, 2),
                            cw, cb, w)
        with pytest.raises(TypeError):
            conv_xproj_cuda(xc, cw.bfloat16(), cb, w)
        with pytest.raises(TypeError):
            conv_xproj_cuda(xc.half(), cw, cb, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_functions_grads_match_plain_autograd_on_card(cuda, dtype):
    """Each Function (kernel forward; analytic or recomputed plain
    backward) against autograd through its plain version."""
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    v = norm_inputs(cuda, dtype, B=2, L=16, D=256, seed=7)
    kw = norm_kwargs(v, NORM_CASES[-1])
    names = ("weight", "bias", "branch", "gate", "residual", "shift",
             "scale")
    x = v["x"].detach().requires_grad_(True)
    leaves = {k: kw[k].detach().requires_grad_(True) for k in names}
    rest = dict(eps=kw["eps"], is_rms=kw["is_rms"],
                total_dtype=kw["total_dtype"])
    before = norm_modulate_cuda.launches
    out, tot = norm_modulate(x, **leaves, **rest, fuse=True)
    assert norm_modulate_cuda.launches == before + 1
    got = torch.autograd.grad((out.float().square().sum()
                               + tot.float().sin().sum()),
                              [x, *leaves.values()])
    out, tot = norm_modulate_ref(x, **leaves, **rest)
    want = torch.autograd.grad((out.float().square().sum()
                                + tot.float().sin().sum()),
                               [x, *leaves.values()])
    for a, b in zip(got, want):
        _close(a, b, tol)

    x2 = v["x"].reshape(-1, 256).detach().requires_grad_(True)
    r2 = v["residual"].reshape(-1, 256).detach().requires_grad_(True)
    w = v["weight"].detach().requires_grad_(True)
    before = add_norm_cuda.launches
    out, tot = fused_add_norm(x2, w, residual=r2, kernel=True)
    assert add_norm_cuda.launches == before + 1
    got = torch.autograd.grad(out.float().square().sum() + tot.sin().sum(),
                              [x2, r2, w])
    out, tot = add_norm_ref(x2, r2, w, None, 1e-5, True, dtype)
    want = torch.autograd.grad(out.float().square().sum() + tot.sin().sum(),
                               [x2, r2, w])
    for a, b in zip(got, want):
        _close(a, b, max(tol, 1e-4))

    xc, cw, cb, wx = (t.detach().requires_grad_(True) for t in
                      conv_inputs(cuda, dtype, 2, 64, 256, 4, 36, seed=8))
    before = conv_xproj_cuda.launches
    got_c, got_d = conv_xproj(xc, cw, cb, wx)
    assert conv_xproj_cuda.launches == before + 1
    got = torch.autograd.grad(got_c.float().sum() + got_d.square().sum(),
                              [xc, cw, cb, wx])
    want_c, want_d = conv_xproj_ref(xc, cw, cb, wx)
    want = torch.autograd.grad(want_c.float().sum() + want_d.square().sum(),
                               [xc, cw, cb, wx])
    for a, b in zip(got, want):
        _close(a, b, max(tol, 1e-4))


# --------------------------------------------------------------------------
# training for real: remat through the kernels, the loader's copy
# --------------------------------------------------------------------------

def _remat_step(model, policy, x, t, y):
    """One sum(out ** 2) backward of `model` with remat under `policy`
    ("off": none), the same generator seed each time; returns the loss,
    the gradients and the kernels' launches."""
    from dimsum_torch.ops import conv_xproj as convx_ops
    from dimsum_torch.ops import selective_scan as scan_ops
    from dimsum_torch.utils import remat

    model.remat_keep = None if policy == "off" else \
        remat.parse_policy(policy)
    model.zero_grad(set_to_none=True)
    fns = (scan_ops.selective_scan_cuda,
           scan_ops.selective_scan_fwd_train_cuda,
           scan_ops.selective_scan_bwd_core_cuda, convx_ops.conv_xproj_cuda)
    for fn in fns:
        fn.launches = 0
    gen = torch.Generator(device=x.device).manual_seed(4)
    loss = (model(x, t, y, train=True, generator=gen) ** 2).sum()
    loss.backward()
    torch.cuda.synchronize()
    return (loss.detach(), {n: p.grad.clone() for n, p in
                            model.named_parameters() if p.grad is not None},
            [fn.launches for fn in fns])


@pytest.mark.parametrize("policy, launches", [
    (None, [0, 8, 4, 8]), ("scan", [0, 4, 4, 8]),
    ("save:conv_out", [0, 8, 4, 4]), ("dots_scan", [0, 4, 4, 8]),
    ("save:attn_out", [0, 8, 4, 8])])
def test_remat_launches_and_grads_through_kernels(cuda, policy, launches):
    """A small DiM (hidden 128, depth 2: 4 mixers; conv + x_proj on, drop
    path 0.3) in fp32 with deterministic settings (TF32 off, cuDNN's
    deterministic algorithms, the math SDPA): per step the scan's training
    forward (kernel 2) and the conv + x_proj kernel launch twice a mixer
    unless the policy keeps their outputs, kernel 3 once, kernel 1 never;
    loss and gradients as without remat, to 4 times the spread of two runs
    without (0 where they agree)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from dimsum_torch.models.dim import DiM, DiMConfig, random_init_

    cfg = DiMConfig(img_resolution=16, hidden_size=128, depth=2,
                    num_classes=10, use_attn_every_k_layers=2,
                    drop_path=0.3, conv_xproj=True, grad_checkpoint=True)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        with torch.device(cuda):
            model = random_init_(DiM(cfg), 0).train()
        g = torch.Generator(device=cuda).manual_seed(1)
        x = torch.randn((3, 4, 16, 16), generator=g, device=cuda)
        t = torch.rand(3, generator=g, device=cuda)
        y = torch.randint(0, 10, (3,), generator=g, device=cuda)
        with sdpa_kernel(SDPBackend.MATH):
            base = _remat_step(model, "off", x, t, y)
            again = _remat_step(model, "off", x, t, y)
            got = _remat_step(model, policy, x, t, y)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags

    def err(run):
        return max((run[1][n] - g).abs().max().item()
                   / g.abs().max().clamp_min(1e-30).item()
                   for n, g in base[1].items())

    assert base[2] == [0, 4, 4, 4] and got[2] == launches
    assert set(got[1]) == set(base[1])
    assert err(got) <= 4 * err(again)
    if err(again) == 0:
        assert torch.equal(got[0], base[0])


def test_loader_batches_reach_the_card_intact(cuda, tmp_path):
    """`device_batches` copies each `Loader` batch from pinned memory on a
    side stream, one batch ahead: every batch read on the card (by a
    kernel on the current stream) equals the host batch."""
    import numpy as np

    from dimsum_torch.data import LatentMemmapDataset, Loader, device_batches
    from dimsum_torch.data.loader import _to_device

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((50, 4, 32, 32)).astype(np.float32)
    xs.tofile(tmp_path / "latents.dat")
    np.arange(50, dtype=np.int64).tofile(tmp_path / "labels.dat")
    ds = LatentMemmapDataset(str(tmp_path / "latents.dat"),
                             str(tmp_path / "labels.dat"))
    assert ds.is_native
    loader = Loader(ds, batch_size=16, seed=2, drop_last=False)
    host = list(loader)
    got = [(x * 2).cpu() for x, _ in device_batches(loader, cuda)]
    assert len(got) == len(host) == 4
    for (hx, _), gx in zip(host, got):
        assert torch.equal(gx, torch.from_numpy(hx * 2))
    labels = torch.cat([y.cpu() for _, y in device_batches(loader, cuda)])
    assert sorted(labels.tolist()) == list(range(50))
    stream = torch.cuda.Stream(cuda)
    x, y, copied = _to_device(host[0], cuda, stream)
    assert x.is_cuda and y.dtype == torch.int64 and copied is not None


def test_inception_on_card_matches_fp64_cpu(cuda):
    """The FID InceptionV3 on the card (fp32, TF32 off inside the
    detector) against the same network in fp64 on the CPU: 1e-4 of the
    features' scale.  The TF32 flags are restored after the call."""
    import copy

    import numpy as np

    from dimsum_torch.eval.inception import (InceptionDetector,
                                             preprocess_uint8)

    det = InceptionDetector.random(0, cuda)
    x = np.random.default_rng(0).integers(0, 256, (4, 3, 256, 256),
                                          dtype=np.uint8)
    before = torch.backends.cudnn.allow_tf32
    got = det(torch.from_numpy(x).to(cuda))
    assert torch.backends.cudnn.allow_tf32 == before
    plain = copy.deepcopy(det.model).to("cpu", torch.float64)
    with torch.no_grad():
        want = plain(preprocess_uint8(torch.from_numpy(x)).double()).numpy()
    assert got.shape == (4, 2048)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_kid_and_pr_torch_on_card_match_numpy(cuda):
    """KID and precision/recall by impl="torch" on the card against the
    numpy route (the shapes of tests/test_pr_jax.py): PR exactly, KID to
    1e-6 relative."""
    import numpy as np

    from dimsum_torch.eval.fid import compute_kid, compute_precision_recall

    rng = np.random.default_rng(0)
    real = rng.standard_normal((1203, 48)).astype(np.float32)
    gen = (0.8 * rng.standard_normal((911, 48)) + 0.7).astype(np.float32)
    assert (compute_precision_recall(real, gen, impl="torch", device=cuda,
                                     row_batch=256)
            == compute_precision_recall(real, gen, impl="numpy"))
    rng = np.random.default_rng(3)
    real = rng.standard_normal((700, 64)).astype(np.float32)
    gen = (rng.standard_normal((650, 64)) * 1.1 + 0.2).astype(np.float32)
    kw = dict(num_subsets=20, max_subset_size=300)
    k_np = compute_kid(real, gen, impl="numpy", **kw)
    k_t = compute_kid(real, gen, device=cuda, **kw)  # auto: torch on CUDA
    assert abs(k_t - k_np) <= 1e-6 * abs(k_np), (k_t, k_np)


# ---------------------------------------------------------------------------
# `use_cond_init` training: the scan's training kernels with the state
# seeded before step 0 (kernel 2's h0 entry) and its gradient out (kernel
# 3's h0 entry), against their plain versions
# ---------------------------------------------------------------------------

def _h0(x, seed=9):
    batch, _, dim = x["u"].shape
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, dim, x["A"].shape[1], generator=g).to(
        x["u"].device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim, n, r, L", [
    (256, 16, 32, 300), (200, 16, 64, 40), (64, 16, 32, 7),
    (1024, 16, 32, 1000), (130, 8, 5, 77)])
def test_h0_training_kernels_match_plain_on_card(cuda, dtype, dim, n, r, L):
    """Kernel 2 from h0 and kernel 3 with dh0 (L not a multiple of the
    16-step chunk, a single ragged chunk at L 7, r 32 and 64): every output
    within the tolerance of the plain versions', dh0 fp32; the first
    saved state is h0 exactly."""
    x = scan_inputs(cuda, dtype, batch=2, L=L, dim=dim, n=n, r=r)
    h0 = _h0(x)
    f0 = selective_scan_fwd_train_cuda.h0_launches
    b0 = selective_scan_bwd_core_cuda.h0_launches
    got_f = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x), h0=h0)
    want_f = selective_scan_fwd_train_ref(*_args(x), **_train_kw(x), h0=h0)
    g = torch.randn(x["u"].shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4)).to(dtype)
    kw = dict(_train_kw(x), o=want_f[1], boundaries=want_f[2], g=g, h0=h0)
    got_b = selective_scan_bwd(*_args(x), **kw)
    want_b = selective_scan_bwd_ref(*_args(x), **kw)
    torch.cuda.synchronize()
    assert selective_scan_fwd_train_cuda.h0_launches == f0 + 1
    assert selective_scan_bwd_core_cuda.h0_launches == b0 + 1
    assert torch.equal(got_f[2][:, 0], h0.transpose(1, 2))
    assert got_b[-1].dtype == torch.float32 and got_b[-1].shape == h0.shape
    names = ("y", "o", "boundaries", "du", "ddelta", "dA", "dB", "dC", "dD",
             "dz", "dbias", "dh0")
    for name, a, b in zip(names, got_f + got_b, want_f + want_b):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        _close(a, b, 1.6e-2 if a.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_h0_kernels_equal_the_h0_free_entries_on_card(cuda, dtype):
    """h0 = 0 through the h0 entries gives the h0-free entries' outputs
    bit for bit (the training mixer shape, 16 x 256 x 1024)."""
    x = scan_inputs(cuda, dtype, batch=16, L=256, dim=1024, n=16, r=32)
    zero = torch.zeros(16, 1024, 16, device=cuda)
    seeded = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x),
                                           h0=zero)
    free = selective_scan_fwd_train_cuda(*_args(x), **_train_kw(x))
    for a, b in zip(seeded, free):
        assert torch.equal(a, b)
    go = torch.randn(x["u"].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2))
    core = (*_args(x)[:6], x["delta_bias"], True, go, free[2])
    seeded = selective_scan_bwd_core_cuda(*core, return_dh0=True)
    free = selective_scan_bwd_core_cuda(*core)
    torch.cuda.synchronize()
    assert len(seeded) == 6
    for a, b in zip(seeded, free):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grad", [False, True])
def test_h0_route_on_card(cuda, grad):
    """`selective_scan_dtlow(..., h0=h0)` on CUDA: without a gradient the
    state entry (delta materialized in the compute dtype, h0 in), with
    one the h0 training kernels once each; against the plain route (and
    its autograd), h0's gradient included."""
    from dimsum_torch.ops.selective_scan import selective_scan_state_cuda

    x = scan_inputs(cuda, torch.float32, batch=2, L=96, dim=192, n=16, r=12)
    x["h0"] = _h0(x)
    names = ("u", "dt_low", "dt_w", "A", "B", "C", "D", "z", "delta_bias",
             "h0")
    leaves = [x[k].requires_grad_(grad) for k in names]
    g = torch.randn(x["u"].shape, device=cuda)

    def run(impl):
        y = selective_scan_dtlow(*_args(x), **_train_kw(x), h0=x["h0"],
                                 impl=impl)
        return torch.autograd.grad(y, leaves, g) if grad else (y,)

    counts = (selective_scan_state_cuda, selective_scan_fwd_train_cuda,
              selective_scan_bwd_core_cuda, selective_scan_cuda)
    before = [fn.launches for fn in counts]
    with torch.set_grad_enabled(grad):
        got = run("cuda")
        want = run("ref")
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counts, before)] == (
        [0, 1, 1, 0] if grad else [1, 0, 0, 0])
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


# ---------------------------------------------------------------------------
# DiT-XL/2's attention shape (2 rows here; L 1024, 16 heads): forward and
# the Function's backward, at Dh 72 (DiT-XL/2 itself) through the Hopper
# redesigns, and at Dh 80 and 128 through the first attention kernel
# (`csrc/full_attention.cu`), which keeps those head sizes
# ---------------------------------------------------------------------------

def _forward_and_grads_match(cuda, dtype, Dh, kernel):
    leaves = [t.detach().requires_grad_(True) for t in
              attn_inputs(cuda, dtype, 2, 1024, 16, Dh, seed=Dh)]
    assert attention_kernel(dtype, Dh) == kernel
    g = torch.randn(leaves[0].shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(7)).to(dtype)
    before = attn_counts()
    out = full_block_attention(*leaves, Dh ** -0.5)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert_one_launch_of(kernel, before)
    ref = full_attention_ref(*leaves, Dh ** -0.5)
    want = torch.autograd.grad(ref, leaves, g)
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    _close(out.detach(), ref.detach(), tol)
    for a, b in zip(got, want):
        _close(a, b, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [80, 128])
def test_first_kernel_at_dit_xl_shape_on_card(cuda, dtype, Dh):
    _forward_and_grads_match(cuda, dtype, Dh, "full_attention_first")


@pytest.mark.parametrize("dtype, kernel", [
    (torch.float32, "full_attention_f32"),
    (torch.bfloat16, "full_attention_sm90")])
def test_redesign_at_dit_xl_shape_on_card(cuda, dtype, kernel):
    _forward_and_grads_match(cuda, dtype, 72, kernel)


# ---------------------------------------------------------------------------
# remat at the full-block attention: one fp32 step of a depth-2 DiT at
# hidden 1152 (Dh 72) and of a depth-2 DiM at hidden 1024 (Dh 64), 512 px
# (L 1024), with and without remat
# ---------------------------------------------------------------------------

def _remat_model(kind, remat_on, cuda):
    import dataclasses

    from dimsum_torch.models.dim import DiM, DiMConfig, random_init_
    from dimsum_torch.models.dit import DiT, DiTConfig
    from dimsum_torch.utils import remat

    if kind == "dit":
        cfg = DiTConfig(img_resolution=64, hidden_size=1152, depth=2,
                        num_heads=16, num_classes=10)
        with torch.device(cuda):
            model = DiT(dataclasses.replace(cfg, grad_checkpoint=remat_on))
    else:
        cfg = DiMConfig(img_resolution=64, hidden_size=1024, depth=2,
                        num_classes=10, use_attn_every_k_layers=2,
                        grad_checkpoint=True)
        with torch.device(cuda):
            model = DiM(cfg)
        model.remat_keep = remat.parse_policy(None) if remat_on else None
    return random_init_(model, 0).train()


@pytest.mark.parametrize("kind, attention_per_forward", [("dit", 2),
                                                         ("dim", 5)])
def test_remat_at_the_full_block_attention_on_card(cuda, kind,
                                                   attention_per_forward):
    """The loss and every gradient with full remat (each block replayed in
    the backward, its attention kernel launched again) equal those
    without, to 4 times the spread of two runs without (0 where they
    agree); TF32 off, cuDNN deterministic."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 4, 64, 64), generator=g, device=cuda)
    t = torch.rand(2, generator=g, device=cuda)
    y = torch.randint(0, 10, (2,), generator=g, device=cuda)
    runs = []
    try:
        for remat_on in (False, False, True):
            model = _remat_model(kind, remat_on, cuda)
            full_block_attention_cuda.launches = 0
            gen = torch.Generator(device=cuda).manual_seed(4)
            loss = (model(x, t, y, train=True, generator=gen) ** 2).mean()
            loss.backward()
            torch.cuda.synchronize()
            runs.append((loss.detach(), {
                n: p.grad for n, p in model.named_parameters()
                if p.grad is not None}, full_block_attention_cuda.launches))
            del model
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    base, again, got = runs

    def err(run):
        return max((run[1][n] - w).abs().max().item()
                   / w.abs().max().clamp_min(1e-30).item()
                   for n, w in base[1].items())

    # the DiM's shared DiT block is not checkpointed: its attention runs
    # once; the combined blocks' two cross attentions twice under remat
    assert base[2] == attention_per_forward
    assert got[2] == (2 * attention_per_forward if kind == "dit"
                      else attention_per_forward + 4)
    assert set(got[1]) == set(base[1])
    assert err(got) <= 4 * err(again)
    if err(again) == 0:
        assert torch.equal(got[0], base[0])
    else:
        assert abs(got[0] - base[0]) <= 4 * abs(again[0] - base[0])
