"""The MoE blocks against the JAX package: `SwitchMLP` (the single-device
dense dispatch) in both routing modes ("top1": softmax; "sinkhorn": a
sigmoid, no Sinkhorn iterations), gated and plain experts, with and
without biases, in fp32 and bf16; `MoEBlock` (add + norm, then the
SwitchMLP); and a small `is_moe` DiM (the config of
tests/test_models.py:185: latent 16, hidden 64, depth 2, linear blocks,
zigma_2, block 1 a MoEBlock; and the published combined block with every
odd block MoE): forward, CFG, the GVP velocity loss and every gradient.
Weights are JAX's, randomized, through `state_dict_from_jax_params`.
The gradients of the first config are taken at depth 3: at depth 2 the
MoE block is the last, and the FinalLayer's LayerNorm does not see a
token's scale, so the router's gradient (through the routing
probability that scales each token) is the LayerNorm eps's alone, 1e-5
of the other gradients' scale (measured 8e-6 against 2e-2), and the two
packages' fp32 results differ there by their rounding (2e-8; the port's
fp32 gradient is as far from its own fp64 one).

Tolerances: fp32 1e-4 of the output's and each gradient's scale (max
|ref|); bf16 5e-2 of the output's scale.  In bf16 the experts' outputs
round differently in the two packages, and a token whose two best
routing probabilities are nearer than the bf16 rounding of the logits
could take another expert on either side: the bf16 comparison keeps only
the tokens whose top-2 gap exceeds 2^-8 of the largest |logit| (the
router itself runs in fp32 in both, as flax promotes its input to the
router's fp32 weights)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.blocks import MoEBlock as JaxMoEBlock
from dimsum_tpu.models.blocks import SwitchMLP as JaxSwitchMLP
from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.utils.ckpt import convert_torch_state_dict
from dimsum_torch.models.blocks import MoEBlock, SwitchMLP
from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (randomize,  # noqa: F401
                                      torch_one_thread)
from tests.test_torch_dit import (FP32_TOL, forward_and_cfg, jax_port_pair,
                                  loss_and_grads)
from tests.test_torch_train import _assert_scaled

D, E = 32, 4
MOE_DIMS = {
    # tests/test_models.py:185
    "linear-zigma_2": dict(img_resolution=16, hidden_size=64, depth=2,
                           num_classes=10, label_dropout=0.1, rms_norm=True,
                           cond_mamba=True, learnable_pe=True, is_moe=True,
                           scan_type="zigma_2", block_type="linear",
                           use_attn_every_k_layers=-1),
    "combined": dict(img_resolution=16, hidden_size=64, depth=4,
                     num_classes=10, label_dropout=0.1, rms_norm=True,
                     cond_mamba=True, learnable_pe=True, is_moe=True,
                     block_type="combined", scan_type="none",
                     use_attn_every_k_layers=2, routing_mode="sinkhorn",
                     num_moe_experts=4),
}


def _switch_pair(seed, **kw):
    jm = JaxSwitchMLP(D, num_moe_experts=E, **{
        k: v for k, v in kw.items() if k != "dtype"},
        dtype=kw.get("dtype", jnp.float32))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 8, D)))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    port = SwitchMLP(D, num_moe_experts=E, **{
        k: v for k, v in kw.items() if k != "dtype"},
        dtype=torch.bfloat16 if kw.get("dtype") == jnp.bfloat16
        else torch.float32)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, port


@pytest.mark.parametrize("routing_mode", ["top1", "sinkhorn"])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_switch_mlp_matches_jax(routing_mode, gated, bias):
    kw = dict(routing_mode=routing_mode, gated_linear_unit=gated,
              add_bias_linear=bias)
    jm, params, port = _switch_pair(3, **kw)
    x = np.random.default_rng(4).standard_normal((2, 8, D)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    # every token takes an expert; more than one expert takes tokens
    route = port.router(torch.from_numpy(x)).argmax(-1)
    assert len(set(route.flatten().tolist())) > 1
    assert got.dtype == torch.float32
    _assert_scaled(got.numpy(), want, FP32_TOL, "switch")


@pytest.mark.parametrize("routing_mode", ["top1", "sinkhorn"])
def test_switch_mlp_bf16_tracks_jax_away_from_ties(routing_mode):
    jm, params, port = _switch_pair(5, routing_mode=routing_mode,
                                    dtype=jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(6).standard_normal((4, 16, D)),
                    jnp.bfloat16)
    want = np.asarray(jax.jit(jm.apply)(params, x), np.float32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    with torch.no_grad():
        got = port(xt)
        logits = port.router(xt)
    assert got.dtype == torch.float32  # bf16 experts scaled by fp32 probs
    probs = (torch.sigmoid(logits) if routing_mode == "sinkhorn"
             else torch.softmax(logits, -1))
    top2 = probs.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 2.0 ** -8
             * logits.abs().max()).numpy()
    assert clear.mean() > 0.5
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want)[clear].max()
    assert err <= 5e-2 * scale


def test_moe_block_matches_jax():
    jm = JaxMoEBlock(D, rms_norm=True, num_moe_experts=E)
    x, res = (np.random.default_rng(s).standard_normal((2, 8, D)).astype(
        np.float32) for s in (7, 8))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, res)
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), 9)
    port = MoEBlock(D, rms_norm=True, num_moe_experts=E)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    want, want_res = jax.jit(jm.apply)(params, x, res)
    with torch.no_grad():
        got, got_res = port(torch.from_numpy(x), torch.from_numpy(res))
    _assert_scaled(got.numpy(), want, FP32_TOL, "hidden")
    _assert_scaled(got_res.numpy(), want_res, FP32_TOL, "residual")


@pytest.fixture(scope="module", params=list(MOE_DIMS))
def moe_dim(request):
    kw = MOE_DIMS[request.param]
    jmodel = JaxDiM(JaxDiMConfig(**kw))
    params, port = jax_port_pair(jmodel, DiM(DiMConfig(**kw)))
    return kw, jmodel, params, port


def test_moe_dim_forward_and_cfg_match_jax(moe_dim):
    kw, jmodel, params, port = moe_dim
    assert isinstance(port.blocks[1], MoEBlock)
    assert not isinstance(port.blocks[0], MoEBlock)
    # the reference's names, back through the JAX converter strictly
    convert_torch_state_dict({k: v.numpy() for k, v in
                              port.state_dict().items()},
                             params["params"], strict=True)
    forward_and_cfg(jmodel, params, port)


@pytest.mark.parametrize("case", list(MOE_DIMS))
def test_moe_dim_loss_and_grads_match_jax(case):
    kw = dict(MOE_DIMS[case])
    if kw["depth"] == 2:  # a block after the MoE block (module docstring)
        kw["depth"] = 3
    jmodel = JaxDiM(JaxDiMConfig(**kw))
    params, port = jax_port_pair(jmodel, DiM(DiMConfig(**kw)), seed=1)
    got = loss_and_grads(jmodel, params, port)
    assert got["blocks.1.mixer.router.weight"].abs().max() > 0
