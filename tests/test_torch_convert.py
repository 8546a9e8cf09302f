"""The port's converter (dimsum_torch/utils/convert.py) against the JAX
package's torch -> flax converter: exact round trips both ways, and the
port's module names load the converted state dict strictly.

Also holds the helpers the other `test_torch_*` files share: a seeded
random fill of a flax params tree and the small DiM configuration."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.utils.ckpt import convert_torch_state_dict
from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.utils.convert import state_dict_from_jax_params

# the small DiM of the port's CPU tests: L = 256 tokens (grid 16), so the
# frequency half takes the 256-px wavelet route of DiM-L/2; the JAX config
# adds the published architecture the port builds without options
SMALL = dict(img_resolution=32, hidden_size=128, depth=4,
             use_attn_every_k_layers=4, num_classes=10)
PUBLISHED = dict(rms_norm=True, block_type="combined", cond_mamba=True,
                 learnable_pe=True)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One PyTorch intra-op thread for a port test module, restored after.
    These tests run many small ops; beside the suite's other xdist workers,
    PyTorch's default of one thread per core oversubscribes the CPU and
    slowed them ~40x (measured: 9.6 s with one thread, > 140 s with eight,
    for the same two tests beside seven busy processes).  Port test modules
    import this fixture, which applies it to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, seed):
    """A copy of a flax params tree with seeded random leaves, so that no
    branch is silenced by the adaLN-Zero init: kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), norm weights and D around 1, A_log = log(1..N)
    plus noise, dt_proj bias the inverse softplus of dt in [1e-3, 0.1]
    (Mamba v2's A_b_log, D_b, dt_proj_b and conv1d_b as their first
    direction's)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        # Mamba v2's second direction fills as the first
        name = {"A_b_log": "A_log", "D_b": "D", "dt_proj_b_bias":
                "dt_proj_bias", "dt_proj_b_kernel": "dt_proj_kernel",
                "conv1d_b_kernel": "conv1d_kernel"}.get(name, name)
        shape = np.shape(leaf)
        r = rng.standard_normal(shape)
        if name == "A_log":
            v = np.log(np.arange(1, shape[1] + 1))[None] + 0.1 * r
        elif name == "D" or name == "weight":
            v = 1.0 + 0.1 * r
        elif name == "dt_proj_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
            v = np.log(np.expm1(dt))
        elif name == "pos_embed":
            v = np.asarray(leaf) + 0.1 * r
        elif name in ("kernel", "dt_proj_kernel"):
            v = r / np.sqrt(shape[0])
        elif name == "conv1d_kernel":
            v = r / np.sqrt(shape[1])
        elif name == "embedding":
            v = 0.5 * r
        else:
            v = 0.1 * r
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def small_models(seed=0, dtype="fp32"):
    """(jax model, randomized jax params, port model with those weights)."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel = JaxDiM(JaxDiMConfig(**SMALL, **PUBLISHED, dtype=jdt))
    x = jnp.zeros((2, 4, 32, 32))
    t = jnp.zeros((2,))
    y = jnp.zeros((2,), jnp.int32)
    params = randomize(
        jax.jit(jmodel.init)(jax.random.PRNGKey(seed), x, t, y), seed)
    port = DiM(DiMConfig(**SMALL, dtype=tdt))
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, params, port.eval()


def _flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_params_round_trip_exact():
    jmodel, params, _ = small_models()
    sd = state_dict_from_jax_params(params)
    back = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, params["params"], strict=True)
    want, got = _flat(params["params"]), _flat(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_port_state_dict_names_match():
    """Every tensor of the port's DiM is produced by the converter, with
    the port's shape: load_state_dict(strict=True) in small_models checks
    names, this checks nothing is left at its constructor value."""
    _, params, port = small_models()
    sd = state_dict_from_jax_params(params)
    own = port.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert own[k].shape == v.shape, k
        torch.testing.assert_close(own[k], v, rtol=0, atol=0)


def test_torch_flax_torch_round_trip_exact():
    """A reference-format torch state dict (the fp64-oracle fixture) ->
    flax through the JAX converter -> back through the port's converter."""
    from tests.test_model_torch_parity import make_model_sd

    sd = make_model_sd(np.random.default_rng(7))
    flax_tree = convert_torch_state_dict(sd, None, strict=False)
    back = state_dict_from_jax_params(flax_tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("path, shape, name, want_shape", [
    (("blocks_3", "spatial_mamba", "mixer", "conv1d_kernel"), (8, 4),
     "blocks.3.spatial_mamba.mixer.conv1d.weight", (8, 1, 4)),
    (("blocks_0", "freq_mamba", "mixer", "dt_proj_kernel"), (2, 8),
     "blocks.0.freq_mamba.mixer.dt_proj.weight", (8, 2)),
    (("x_embedder", "proj", "kernel"), (16, 8),
     "x_embedder.proj.weight", (8, 4, 2, 2)),
    (("final_layer", "adaLN_modulation_fc", "kernel"), (8, 16),
     "final_layer.adaLN_modulation.1.weight", (16, 8)),
    (("t_embedder", "mlp_2", "bias"), (8,), "t_embedder.mlp.2.bias", (8,)),
    (("y_embedder", "embedding_table", "embedding"), (11, 8),
     "y_embedder.embedding_table.weight", (11, 8)),
    (("attn_block", "adaLN_modulation", "fc", "bias"), (48,),
     "attn_block.adaLN_modulation.1.bias", (48,)),
])
def test_name_and_layout_maps(path, shape, name, want_shape):
    tree = {}
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    (got_name, got), = state_dict_from_jax_params(tree).items()
    assert got_name == name
    assert tuple(got.shape) == want_shape
