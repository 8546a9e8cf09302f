"""The port against the JAX package's pinned golden outputs
(tests/goldens/model_outputs.npz): the small combined DiM ("dim_out") and
the small DiT ("dit_out") of tests/test_goldens.py, with that test's
configs, inputs and weights (the JAX `init` at its key, every leaf + 0.01)
carried to the port by `state_dict_from_jax_params`, held to the goldens
at that test's rtol / atol of 1e-4."""

import dataclasses
import os

import numpy as np
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.dim import DiM as JaxDiM
from dimsum_tpu.models.dim import DiMConfig as JaxDiMConfig
from dimsum_tpu.models.dit import DiT as JaxDiT
from dimsum_tpu.models.dit import DiTConfig as JaxDiTConfig
from dimsum_torch.models.dim import DiM, DiMConfig
from dimsum_torch.models.dit import DiT, DiTConfig
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import torch_one_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "model_outputs.npz")


def _inputs():
    x = jax.random.normal(jax.random.PRNGKey(10), (2, 4, 16, 16))
    return np.array(x), np.array([0.25, 0.75], np.float32), np.array(
        [3, 7], np.int32)


def _port_output(jmodel, key, port_cls, port_cfg):
    """The port's forward with tests/test_goldens.py's weights: the JAX
    init at `key`, + 0.01."""
    x, t, y = _inputs()
    params = jmodel.init(jax.random.PRNGKey(key), jnp.asarray(x),
                         jnp.asarray(t), jnp.asarray(y))
    params = jax.tree.map(lambda a: np.asarray(a + 0.01), params)
    port = port_cls(port_cfg)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        return port.eval()(torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(y).long()).numpy()


def _same_fields(jcfg, port_cls):
    """The JAX config's values of every field the port's config has (its
    defaults differ), the dtype left at fp32."""
    names = {f.name for f in dataclasses.fields(port_cls)} - {"dtype"}
    return port_cls(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(jcfg) if f.name in names})


def test_dim_combined_golden_in_the_port():
    jcfg = JaxDiMConfig(img_resolution=16, patch_size=2, hidden_size=64,
                        depth=2, num_classes=10, rms_norm=True,
                        block_type="combined", cond_mamba=True,
                        learnable_pe=True, use_attn_every_k_layers=2,
                        scan_impl="xla")
    out = _port_output(JaxDiM(jcfg), 11, DiM, _same_fields(jcfg, DiMConfig))
    np.testing.assert_allclose(out, np.load(GOLDEN)["dim_out"], rtol=1e-4,
                               atol=1e-4)


def test_dit_golden_in_the_port():
    jcfg = JaxDiTConfig(img_resolution=16, patch_size=2, hidden_size=64,
                        depth=2, num_heads=4, num_classes=10)
    out = _port_output(JaxDiT(jcfg), 12, DiT, _same_fields(jcfg, DiTConfig))
    np.testing.assert_allclose(out, np.load(GOLDEN)["dit_out"], rtol=1e-4,
                               atol=1e-4)
