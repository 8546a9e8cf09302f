"""The position encodings beside the APE against the JAX package: the 2-D
rotary tables, `rotate_half` and `apply_rotary` (`pe_type` "rope"), the
conditional position CNN `AdaInPosCNN` ("cpe": a depthwise 3 x 3 conv plus
the tokens, then a LayerNorm modulated by adaLN), the four functions of
`models/pe_extras.py`, and a small DiM of each type (latent 16, hidden
64, depth 2, the published combined block): forward and CFG, and for cpe
the GVP velocity loss and every gradient (its conv's among them).

Tolerances: the tables and rotations are exact or within fp32 rounding
(1e-6 of their scale); modules and models fp32 1e-4 of the output's and
each gradient's scale."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models import embedders as jax_emb
from dimsum_tpu.models import pe_extras as jax_pe
from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_torch.models import embedders, pe_extras
from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import (randomize,  # noqa: F401
                                      torch_one_thread)
from tests.test_torch_dit import (FP32_TOL, forward_and_cfg, jax_port_pair,
                                  loss_and_grads)
from tests.test_torch_train import _assert_scaled

PE_DIM = dict(img_resolution=16, hidden_size=64, depth=2, num_classes=10,
              label_dropout=0.1, rms_norm=True, cond_mamba=True,
              block_type="combined", use_attn_every_k_layers=2)


@pytest.mark.parametrize("dim, grid", [(64, 8), (1024, 16)])
def test_rotary_tables_match_jax(dim, grid):
    want = jax_emb.get_2d_sincos_rotary_embed(dim, grid)
    got = embedders.get_2d_sincos_rotary_embed(dim, grid)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_rotate_half_and_apply_rotary_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    sin, cos = jax_emb.get_2d_sincos_rotary_embed(32, 8)
    np.testing.assert_array_equal(
        embedders.rotate_half(torch.from_numpy(x)).numpy(),
        np.asarray(jax_emb.rotate_half(x)))
    want = np.asarray(jax_emb.apply_rotary(x, sin, cos))
    got = embedders.apply_rotary(torch.from_numpy(x), torch.from_numpy(sin),
                                 torch.from_numpy(cos)).numpy()
    _assert_scaled(got, want, 1e-6, "apply_rotary")


def test_ada_in_pos_cnn_matches_jax():
    jm = jax_emb.AdaInPosCNN(32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 36, 32)).astype(np.float32)
    c = rng.standard_normal((2, 32)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, x, c, H=6, W=6),
                            jax.random.PRNGKey(0))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), 2)
    port = embedders.AdaInPosCNN(32)
    # the converter knows the module by its place in the DiM, "pos_cnn"
    sd = state_dict_from_jax_params({"pos_cnn": params["params"]})
    port.load_state_dict({k.removeprefix("pos_cnn."): v
                          for k, v in sd.items()}, strict=True)
    want = np.asarray(jax.jit(lambda p: jm.apply(p, x, c, H=6, W=6))(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(c), 6, 6).numpy()
    _assert_scaled(got, want, FP32_TOL, "pos_cnn")


@pytest.mark.parametrize("dim, pt, ft", [(32, 16, None), (64, 8, 12)])
def test_vision_rotary_matches_jax(dim, pt, ft):
    want_cos, want_sin = jax_pe.vision_rotary_freqs(dim, pt, ft)
    got_cos, got_sin = pe_extras.vision_rotary_freqs(dim, pt, ft)
    np.testing.assert_array_equal(got_cos.numpy(), np.asarray(want_cos))
    np.testing.assert_array_equal(got_sin.numpy(), np.asarray(want_sin))
    n = (ft or pt) ** 2
    x = np.random.default_rng(3).standard_normal((2, n, dim)).astype(
        np.float32)
    np.testing.assert_array_equal(
        pe_extras.rotate_half_interleaved(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pe.rotate_half_interleaved(x)))
    want = np.asarray(jax_pe.apply_vision_rotary(x, want_cos, want_sin))
    got = pe_extras.apply_vision_rotary(torch.from_numpy(x), got_cos,
                                        got_sin).numpy()
    _assert_scaled(got, want, 1e-6, "apply_vision_rotary")


@pytest.mark.parametrize("n, dim", [(16, 32), (100, 10)])
def test_sinusoidal_pos_embed_matches_jax(n, dim):
    np.testing.assert_array_equal(
        pe_extras.sinusoidal_pos_embed_1d(n, dim).numpy(),
        np.asarray(jax_pe.sinusoidal_pos_embed_1d(n, dim)))


@pytest.fixture(scope="module", params=["rope", "cpe"])
def pe_dim(request):
    kw = dict(PE_DIM, pe_type=request.param)
    jmodel = JaxDiM(JaxDiMConfig(**kw))
    params, port = jax_port_pair(jmodel, DiM(DiMConfig(**kw)))
    return kw, jmodel, params, port


def test_pe_dim_forward_and_cfg_match_jax(pe_dim):
    kw, jmodel, params, port = pe_dim
    assert not hasattr(port, "pos_embed")  # only the APE has a table
    assert ("pos_cnn.proj.0.weight" in port.state_dict()) == (
        kw["pe_type"] == "cpe")
    forward_and_cfg(jmodel, params, port)


def test_cpe_dim_loss_and_grads_match_jax():
    kw = dict(PE_DIM, pe_type="cpe")
    jmodel = JaxDiM(JaxDiMConfig(**kw))
    params, port = jax_port_pair(jmodel, DiM(DiMConfig(**kw)), seed=3)
    got = loss_and_grads(jmodel, params, port)
    assert got["pos_cnn.proj.0.weight"].abs().max() > 0
