"""The port's modules against the JAX package's, with the same weights (JAX
`init`, refilled with seeded random values so no adaLN gate is zero, then
carried across by `state_dict_from_jax_params`) and the same numpy inputs:
the CondMamba mixer, the DiT attention block, and the combined block at each
of the four (reverse, transpose) positions of the depth schedule, at grid 16
(L 256, the 256-px wavelet route).

Tolerance: fp32, 1e-4.  The JAX mixer scans with an associative (tree)
scan on the CPU and the port with the sequential recurrence, which differ
by ~1e-5 at L 256; the rest agrees to summation order."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.blocks import DiMBlockCombined as JaxCombined
from dimsum_tpu.models.blocks import DiTBlock as JaxDiTBlock
from dimsum_tpu.models.mamba import Mamba as JaxMamba
from dimsum_torch.models.blocks import DiMBlockCombined, DiTBlock
from dimsum_torch.models.mamba import Mamba
from dimsum_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_convert import randomize

L, DIM = 256, 32
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, width=DIM):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, width)).astype(np.float32)
    res = rng.standard_normal((2, L, width)).astype(np.float32)
    c = rng.standard_normal((2, DIM)).astype(np.float32)
    return x, res, c


def _port(module, jax_params, prefix=""):
    """Load randomized JAX params into a port module; `prefix` wraps a
    params tree whose names need a parent scope (the mixer's)."""
    tree = {prefix: jax_params["params"]} if prefix else jax_params
    sd = state_dict_from_jax_params(tree)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_condmamba_matches_jax():
    x, _, c = _inputs(0, width=16)
    jm = JaxMamba(d_model=16, d_cond=DIM)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(c)), 0)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(c))
    port = _port(Mamba(16, d_cond=DIM), params, prefix="mixer")
    with torch.no_grad():
        got = port(_t(x), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dit_block_matches_jax():
    x, _, c = _inputs(1)
    jb = JaxDiTBlock(DIM, 16)
    params = randomize(jb.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               jnp.asarray(c)), 1)
    want = jb.apply(params, jnp.asarray(x), jnp.asarray(c))
    port = _port(DiTBlock(DIM, 16), params)
    with torch.no_grad():
        got = port(_t(x), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer", [0, 1, 2, 3])
@pytest.mark.parametrize("with_residual", [False, True])
def test_combined_block_schedule_matches_jax(layer, with_residual):
    """Layer i of the depth schedule: reverse = i % 2 > 0, transpose =
    i % 4 >= 2 (the frequency half's scan is column-first when reversed)."""
    x, res, c = _inputs(10 + layer)
    res = res if with_residual else None
    reverse, transpose = layer % 2 > 0, layer % 4 >= 2
    jb = JaxCombined(dim=DIM, mixer_kwargs=dict(layer_idx=layer,
                                                 scan_type="none",
                                                 d_cond=DIM),
                     rms_norm=True, reverse=reverse, transpose=transpose)
    args = (jnp.asarray(x), None if res is None else jnp.asarray(res),
            jnp.asarray(c))
    params = randomize(jb.init(jax.random.PRNGKey(layer), *args), layer)
    want, want_res = jb.apply(params, *args)
    port = _port(DiMBlockCombined(DIM, reverse=reverse, transpose=transpose,
                                  d_cond=DIM), params)
    with torch.no_grad():
        got, got_res = port(_t(x), _t(res), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got_res.dtype == torch.float32
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res), **TOL)
