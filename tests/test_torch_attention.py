"""The port's full-block attention (`dimsum_torch/ops/full_attention.py`)
and attention modules at L = 1024 against the JAX package's, from the same
numpy inputs:

  * `full_attention_ref` against the JAX `full_block_attention` running
    the Pallas `_attn_kernel` in interpret mode (DIMSUM_ATTN_INTERPRET=1),
    at (2, 128, 4, 64) and (1, 1024, 2, 64), at logits of order 1e3 (also
    at (1, 1024, 2, 72) in fp32), and in bf16, where both round P to bf16
    before P V;
  * the port's Function (its CPU route) differentiated against `jax.grad`
    of the JAX function (its custom_vjp recomputes through XLA);
  * `Attention` (dim 256, 4 heads) and `CrossAttentionFusion` (dim 1024,
    8 heads) at L = 1024, Dh 64, where the port takes the full-block route,
    against the JAX modules (which take XLA's attention on the CPU), with
    the converter's weights;
  * which route each shape takes.

Tolerances, fp32: 2e-5 relative and absolute, the JAX test's own bound for
its kernel against XLA (tests/test_full_attention.py): the same fp32
products summed in other orders.  bf16: 2e-2 absolute on outputs of order
1: the two packages may round a P entry or the output to neighbouring bf16
values (2^-8 relative) after fp32 sums in other orders."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.attention import Attention as JaxAttention
from dimsum_tpu.models.attention import \
    CrossAttentionFusion as JaxCrossAttentionFusion
from dimsum_tpu.ops.full_attention import \
    full_block_attention as jax_full_block_attention
from dimsum_tpu.ops.full_attention import \
    full_block_supported as jax_full_block_supported
from dimsum_torch.models import attention as port_attention
from dimsum_torch.models.attention import (Attention, CrossAttentionFusion,
                                           takes_full_block)
from dimsum_torch.ops.full_attention import (attention_kernel,
                                             full_attention_ref,
                                             full_block_attention,
                                             full_block_supported)
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import randomize, torch_one_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("DIMSUM_ATTN_INTERPRET", "1")


def _qkv(seed, B, L, H, Dh, logit_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H, Dh)).astype(np.float32)
               for _ in range(3))
    return q * logit_scale, k * logit_scale, v


@pytest.mark.parametrize("B, L, H, Dh", [(2, 128, 4, 64), (1, 1024, 2, 64)])
def test_full_attention_ref_matches_jax_kernel(B, L, H, Dh):
    q, k, v = _qkv(L, B, L, H, Dh)
    want = jax_full_block_attention(*map(jnp.asarray, (q, k, v)),
                                    Dh ** -0.5)
    got = full_attention_ref(*map(torch.from_numpy, (q, k, v)), Dh ** -0.5)
    assert got.shape == (B, L, H, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_attention_ref_large_logits_match_jax_kernel():
    """Logits of order 1e3 (q and k 40x N(0, 1), as the JAX stability
    test): the row max keeps exp finite in both."""
    q, k, v = _qkv(2, 1, 128, 1, 64, logit_scale=40.0)
    want = jax_full_block_attention(*map(jnp.asarray, (q, k, v)), 0.125)
    got = full_attention_ref(*map(torch.from_numpy, (q, k, v)), 0.125)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_attention_ref_large_logits_at_dh72_match_jax_kernel():
    """fp32 at L 1024, Dh 72 (DiT-XL/2's and DiM-XL/2's heads) and its
    scale 72^-1/2, at logits of order 1e3: the plain version at the shape
    and logits the card holds the Dh-72 kernels to."""
    q, k, v = _qkv(72, 1, 1024, 2, 72, logit_scale=40.0)
    want = jax_full_block_attention(*map(jnp.asarray, (q, k, v)),
                                    72 ** -0.5)
    got = full_attention_ref(*map(torch.from_numpy, (q, k, v)), 72 ** -0.5)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_attention_ref_bf16_matches_jax_kernel():
    """bf16 in and out: q pre-scaled in bf16, P rounded to bf16 before
    P V, in both packages."""
    q, k, v = _qkv(3, 2, 256, 2, 72)
    scale = 72 ** -0.5  # not a power of two: its bf16 rounding shows
    want = jax_full_block_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale)
    got = full_attention_ref(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2e-2)


def test_full_block_attention_grads_match_jax():
    """The port's Function on CPU tensors (plain forward, recomputed plain
    backward) against jax.grad through the JAX custom_vjp."""
    B, L, H, Dh = 2, 128, 2, 64
    q, k, v = _qkv(1, B, L, H, Dh)

    def jloss(q, k, v):
        o = jax_full_block_attention(q, k, v, Dh ** -0.5)
        return (o * jnp.cos(o)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = full_block_attention(*leaves, Dh ** -0.5)
    (o * torch.cos(o)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **TOL)


def _port(module, params):
    module.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return module.eval()


def test_attention_module_at_L1024_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1024, 256)).astype(np.float32)
    jm = JaxAttention(num_heads=4)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    want = jm.apply(params, jnp.asarray(x))
    port = _port(Attention(256, 4), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_fusion_at_L1024_matches_jax():
    rng = np.random.default_rng(5)
    x1, x2 = (rng.standard_normal((2, 1024, 512)).astype(np.float32)
              for _ in range(2))
    jm = JaxCrossAttentionFusion(dim=1024, num_heads=8, qkv_bias=True)
    params = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x1),
                               jnp.asarray(x2)), 5)
    want = jm.apply(params, jnp.asarray(x1), jnp.asarray(x2))
    port = _port(CrossAttentionFusion(1024, 8, qkv_bias=True), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("L, Dh", [(1024, 64), (1024, 72), (1024, 128),
                                   (2048, 64), (1000, 64), (1024, 60),
                                   (256, 64), (128, 8)])
def test_full_block_gate_matches_jax(L, Dh):
    assert full_block_supported(L, Dh) == jax_full_block_supported(L, Dh)


@pytest.mark.parametrize("L, Dh, full", [
    (1024, 64, True),    # 512 px: DiTBlock (1024 / 16) and cross (512 / 8)
    (1024, 72, True),    # DiM-XL/2 at 512 px (1152 / 16)
    (256, 64, False),    # 256 px: XLA's attention in the JAX package
    (1024, 32, False),   # Dh < 64
    (1024, 8, False),    # the narrow test models
    (2048, 64, False),   # past the full-block gate
])
def test_routing(monkeypatch, L, Dh, full):
    """Which attention `_sdpa` takes: the full-block Function (the kernel
    on the card), its plain version with impl "ref", or SDPA."""
    assert takes_full_block(L, Dh) == full
    calls = []
    for name in ("full_block_attention", "full_attention_ref"):
        monkeypatch.setattr(port_attention, name,
                            lambda *a, _n=name: calls.append(_n) or a[0])
    monkeypatch.setattr(port_attention.F, "scaled_dot_product_attention",
                        lambda q, k, v: calls.append("sdpa") or q)
    q = torch.zeros(1, L, 1, Dh)
    port_attention._sdpa(q, q, q)
    port_attention._sdpa(q, q, q, "ref")
    want = (["full_block_attention", "full_attention_ref"] if full
            else ["sdpa", "sdpa"])
    assert calls == want
    with pytest.raises(ValueError, match="impl"):
        port_attention._sdpa(q, q, q, "cuda")


@pytest.mark.parametrize("dtype, Dh, kernel", [
    (torch.bfloat16, 64, "full_attention_sm90"),  # DiM-L/2 at 512 px
    (torch.float32, 64, "full_attention_f32"),    # the default fp32 sampling
    (torch.bfloat16, 72, "full_attention_sm90"),  # DiT-XL/2's, DiM-XL/2's
    (torch.bfloat16, 128, "full_attention_first"),
    (torch.float32, 72, "full_attention_f32"),
    (torch.float32, 128, "full_attention_first"),
    (torch.bfloat16, 80, "full_attention_first"),  # no model of the zoo
    (torch.float32, 80, "full_attention_first"),
    (torch.float16, 64, "full_attention_first"),  # refused later, by dtype
])
def test_kernel_route_by_dtype_and_head_size(dtype, Dh, kernel):
    """Inside the CUDA wrapper: bf16 at Dh 64 and 72 goes to the TMA +
    wgmma kernel, fp32 at Dh 64 and 72 to `csrc/full_attention_f32.cu`,
    everything else (Dh 80-128) to `csrc/full_attention.cu`; a plain
    function of dtype and Dh, fixed
    before any launch, that names a launch-counted wrapper."""
    from dimsum_torch.ops import full_attention

    assert attention_kernel(dtype, Dh) == kernel
    assert getattr(full_attention, kernel).launches >= 0


@pytest.mark.parametrize("name", [
    "attn_sm90_kernel<64>", "attn_sm90_kernel<72>",
    "attn_fp32_sm90_kernel<64>", "attn_fp32_sm90_kernel<72>",
    "attn_bf16_kernel<80>", "attn_f32_kernel<128>"])
def test_profiler_class_of_each_attention_kernel(name):
    """`profile_forward` counts every instantiation of the three
    attention sources as the full-block attention, apart from the library
    attention class."""
    from dimsum_torch.profile_forward import kernel_class

    assert kernel_class(f"void (anonymous namespace)::{name}(...)") \
        == "full_block_attention"


def test_profile_forward_builds_dit_xl_as_the_cli_does():
    """`profile_forward --model DiT-XL/2 --image-size 512` profiles the
    model the sampling CLI builds: hidden 1152, 16 heads (Dh 72), 28
    blocks, latent 64 (L 1024), a null class for CFG; a fused switch the
    model lacks is refused."""
    from dimsum_torch.profile_forward import zoo_config

    off = dict(pallas_norm=False, fused_norm=False, conv_xproj=False,
               pending_tail=0)
    cfg = zoo_config("DiT-XL/2", 512, "bf16", off)
    assert (cfg.hidden_size // cfg.num_heads, cfg.depth, cfg.img_resolution,
            cfg.dtype, cfg.num_classes) == (72, 28, 64, torch.bfloat16, 1000)
    assert cfg.label_dropout > 0
    assert takes_full_block(cfg.num_patches, 72)
    assert zoo_config("DiT-XL/2", 512, "bf16",
                      {**off, "fused_norm": True}).fused_norm
    with pytest.raises(ValueError, match="no switch"):
        zoo_config("DiT-XL/2", 512, "bf16", {**off, "conv_xproj": True})
