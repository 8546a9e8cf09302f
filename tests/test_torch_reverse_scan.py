"""Reversed time in the port against the JAX package: the selective scan's
reverse route, the mixers that run it (Mamba v2's `_b` branch and
`reverse_tokens`), and the reversed blocks, which run the reverse inside
their mixer when nothing needs a gradient (the JAX
`DIMSUM_NATIVE_REVERSE`) and flip around it when something does.

  * The port's plain reverse route (flips around the sequential
    recurrence, the JAX XLA route) against the Pallas kernel's reverse-time
    case (`_scan_body(reverse=True)`, chunks last to first), run in
    interpret mode, at L 64 (4 chunks of 16) and at L 72 (3 chunks of 24,
    not a multiple of 16: the CUDA kernel's ragged chunk; its own card
    tests are in test_torch_kernels_cuda.py).  2e-4, as the forward
    kernel's test (exp as exp2, a tree order).
  * The v2 mixer, plain Mamba with `reverse_tokens`, and v2 with
    `reverse_tokens`, against JAX's: 1e-4 (tests/test_torch_modules.py).
  * The combined block's reverse inside the mixer equals its flip route bit
    for bit on the CPU (the anticausal conv sums in the causal one's order,
    and the plain scan flips as the block would), and JAX's under
    DIMSUM_NATIVE_REVERSE=1 within 1e-4; which route a block takes, with
    and without a gradient, and the blocks that always flip."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.blocks import DiMBlockCombined as JaxCombined
from dimsum_tpu.models.mamba import Mamba as JaxMamba
from dimsum_tpu.ops.selective_scan import selective_scan_dtlow as jax_dtlow
from dimsum_torch.models.blocks import DiMBlockCombined
from dimsum_torch.models.mamba import Mamba
from dimsum_torch.ops.selective_scan import selective_scan_dtlow
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_modules import _inputs, _port, _t, randomize
from tests.test_torch_selective_scan import make_inputs

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L, chunk", [(64, 16), (72, 24)])
def test_plain_reverse_matches_pallas_reverse_kernel(L, chunk, monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("DIMSUM_SCAN_CHUNK", str(chunk))
    x = make_inputs(np.random.default_rng(L), batch=2, L=L, dim=128, n=8)
    with pltpu.force_tpu_interpret_mode():
        want = jax_dtlow(
            *(jnp.asarray(x[k]) for k in ("u", "dt_low", "dt_w", "A", "B",
                                          "C", "D")),
            z=jnp.asarray(x["z"]), delta_bias=jnp.asarray(x["bias"]),
            delta_softplus=True, impl="pallas", reverse=True)
    got = selective_scan_dtlow(
        *(_t(x[k]) for k in ("u", "dt_low", "dt_w", "A", "B", "C", "D")),
        z=_t(x["z"]), delta_bias=_t(x["bias"]), delta_softplus=True,
        reverse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    # the reverse is not the forward scan: the check has teeth
    fwd = selective_scan_dtlow(
        *(_t(x[k]) for k in ("u", "dt_low", "dt_w", "A", "B", "C", "D")),
        z=_t(x["z"]), delta_bias=_t(x["bias"]), delta_softplus=True)
    assert (fwd - got).abs().max() > 1e-2


@pytest.mark.parametrize("scan_type, reverse_tokens, d_cond", [
    ("v2", False, 32), ("v2", False, None), ("none", True, None),
    ("v2", True, 32)])
def test_mixer_directions_match_jax(scan_type, reverse_tokens, d_cond):
    x, _, c = _inputs(3, width=16)
    jm = JaxMamba(d_model=16, d_cond=d_cond, scan_type=scan_type,
                  reverse_tokens=reverse_tokens)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(c)), 0)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(c))
    port = _port(Mamba(16, d_cond=d_cond, scan_type=scan_type), params,
                 prefix="mixer")
    with torch.no_grad():
        got = port(_t(x), _t(c), reverse_tokens=reverse_tokens)
        # reverse_tokens is the mixer on reversed tokens, reversed back
        flipped = port(_t(x).flip(1), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if reverse_tokens:
        torch.testing.assert_close(got, flipped.flip(1), rtol=0, atol=0)


def test_mixer_refuses_what_jax_refuses():
    zig = Mamba(16, scan_type="jpeg_2", zigzag_paths=np.zeros((1, 4)),
                zigzag_paths_reverse=np.zeros((1, 4)))
    with pytest.raises(NotImplementedError, match="zigzag"):
        zig(torch.zeros(1, 4, 16), reverse_tokens=True)
    for scan_type in ("v2", "zigma_8"):
        with pytest.raises(NotImplementedError, match="seq_group"):
            Mamba(16, scan_type=scan_type, seq_group=object(),
                  zigzag_paths=np.zeros((1, 4)),
                  zigzag_paths_reverse=np.zeros((1, 4)))


@pytest.mark.parametrize("layer", [1, 3])
def test_native_reverse_combined_block(layer, monkeypatch):
    """The reversed positions of the depth schedule (reverse, and with it
    transpose at layer 3)."""
    x, res, c = _inputs(20 + layer)
    transpose = layer % 4 >= 2
    monkeypatch.setenv("DIMSUM_NATIVE_REVERSE", "1")
    jb = JaxCombined(dim=32, mixer_kwargs=dict(layer_idx=layer,
                                                scan_type="none", d_cond=32),
                     rms_norm=True, reverse=True, transpose=transpose)
    args = (jnp.asarray(x), jnp.asarray(res), jnp.asarray(c))
    params = randomize(jb.init(jax.random.PRNGKey(layer), *args), layer)
    want, _ = jb.apply(params, *args)
    port = _port(DiMBlockCombined(32, reverse=True, transpose=transpose,
                                  d_cond=32), params)
    assert port.spatial_mamba.native
    outs = []
    for native in (True, False):  # False: the flips, forced
        port.spatial_mamba.native = native
        with torch.no_grad():
            outs.append(port(_t(x), _t(res), _t(c))[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), **TOL)


def test_reversed_block_flips_only_under_a_gradient(monkeypatch):
    """The mixer of a reversed block takes the reverse itself under no_grad
    and the block flips around it when the input needs a gradient; both
    give the same output, and the gradient flows."""
    calls = []
    forward = Mamba.forward

    def spy(self, x, cond_emb=None, reverse_tokens=False):
        calls.append(reverse_tokens)
        return forward(self, x, cond_emb, reverse_tokens=reverse_tokens)

    monkeypatch.setattr(Mamba, "forward", spy)
    torch.manual_seed(0)
    block = DiMBlockCombined(32, reverse=True, d_cond=32)
    for p in block.parameters():
        p.data.normal_(0.0, 0.2)
    x, res, c = (_t(v) for v in _inputs(31))
    with torch.no_grad():
        want = block(x, res, c)[0]
    # the spatial half's mixer, then the wavelet half's
    assert calls == [True, False]
    calls.clear()
    xg = x.clone().requires_grad_(True)
    got = block(xg, res, c)[0]
    assert calls == [False, False]
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    got.square().sum().backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().max() > 0


def test_zigzag_and_sequence_parallel_blocks_keep_the_flips():
    from dimsum_torch.models.blocks import MixerBlockCore

    zig = MixerBlockCore(16, 16, dict(scan_type="jpeg_2", layer_idx=0,
                                      zigzag_paths=np.zeros((1, 4), int),
                                      zigzag_paths_reverse=np.zeros((1, 4),
                                                                    int)),
                         reverse=True)
    sp = MixerBlockCore(16, 16, dict(seq_group=object(), seq_island=True),
                        reverse=True)
    plain = MixerBlockCore(16, 16, {}, reverse=True)
    forward = MixerBlockCore(16, 16, {})
    assert (zig.native, sp.native, plain.native, forward.native) == (
        False, False, True, False)
