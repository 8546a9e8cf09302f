"""The port's SD-VAE (`dimsum_torch/models/vae.py`) against the JAX
package's (`dimsum_tpu/models/vae.py`):

  * a small VAE (ch 32, ch_mult (1, 2), 16 px images) on seeded weights in
    the diffusers layout, loaded into the port as they are and into JAX
    through `convert_diffusers_vae`: `encode_moments`, `encode` (JAX's
    normal draw injected) and `decode`, fp32, within 1e-4 of each output's
    scale (the two frameworks' convolution and GroupNorm sums);
  * the full-width port's keys and shapes (built on the meta device): the
    set `convert_diffusers_vae` reads, each in the layout the JAX module
    holds it;
  * `load_vae`: a saved state dict loads strictly with the architecture
    its shapes give, old 1x1-conv attention weights too; "random:<seed>"
    is seeded; `.safetensors` without the package names the package."""

import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.models.vae import AutoencoderKL as JaxVAE
from dimsum_tpu.models.vae import convert_diffusers_vae
from dimsum_torch.models.vae import (SD_SCALE_FACTOR, AutoencoderKL,
                                     architecture, load_vae)
from tests.test_torch_convert import torch_one_thread  # noqa: F401

SMALL = dict(ch=32, ch_mult=(1, 2))


def seeded_vae(seed, **arch):
    """A port VAE with seeded weights (norms around 1, every bias set)."""
    vae = AutoencoderKL(**arch)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in vae.named_parameters():
            r = torch.from_numpy(rng.standard_normal(p.shape).astype(
                np.float32))
            if "norm" in name and name.endswith("weight"):
                p.copy_(1 + 0.1 * r)
            elif name.endswith("bias"):
                p.copy_(0.05 * r)
            else:
                p.copy_(r / np.sqrt(p[0].numel()))
    return vae.eval()


def _flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_template(**arch):
    module = JaxVAE(**arch)
    return module, jax.eval_shape(
        module.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)),
        jax.random.PRNGKey(1))["params"]


def _full_keys():
    with torch.device("meta"):
        full = AutoencoderKL()
    return {k: tuple(v.shape) for k, v in full.state_dict().items()}


def to_jax_params(sd, template):
    """`convert_diffusers_vae` reads the SD-VAE's four levels; a smaller
    VAE's dict gets placeholder entries for the levels it lacks, and the
    converted tree keeps what the JAX module holds."""
    full = {k: np.zeros((1,) * len(s), np.float32)
            for k, s in _full_keys().items()}
    tree = _flat(convert_diffusers_vae({**full, **sd}))
    want = _flat(template)
    out = {}
    for path, spec in want.items():
        leaf = np.asarray(tree[path])
        assert leaf.shape == spec.shape, path
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def small_pair():
    port = seeded_vae(0, **SMALL)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    module, template = _jax_template(**SMALL)
    return port, module, {"params": to_jax_params(sd, template)}


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, 3, 16, 16)).astype(np.float32)


def _assert_scaled(got, want, tol=1e-4):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale)


def test_small_vae_encode_moments_match_jax(small_pair):
    port, module, params = small_pair
    x = _images(1)
    want_mean, want_logvar = module.apply(params, x,
                                          method=module.encode_moments)
    with torch.no_grad():
        mean, logvar = port.encode_moments(torch.from_numpy(x))
    assert mean.shape == (2, 4, 8, 8)
    _assert_scaled(mean, want_mean)
    _assert_scaled(logvar, want_logvar)


def test_small_vae_encode_with_injected_noise_matches_jax(small_pair):
    port, module, params = small_pair
    x = _images(2)
    key = jax.random.PRNGKey(3)
    want = module.apply(params, x, key, method=module.encode)
    noise = np.asarray(jax.random.normal(key, (2, 4, 8, 8), jnp.float32))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x), noise=torch.tensor(noise))
        mean, _ = port.encode_moments(torch.from_numpy(x))
    _assert_scaled(got, want)
    assert not torch.allclose(got, mean * SD_SCALE_FACTOR)


def test_small_vae_decode_matches_jax(small_pair):
    port, module, params = small_pair
    z = np.random.default_rng(4).standard_normal((2, 4, 8, 8)).astype(
        np.float32)
    want = module.apply(params, z, method=module.decode)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert got.shape == (2, 3, 16, 16) and got.dtype == torch.float32
    _assert_scaled(got, want)


def test_full_width_keys_are_what_the_jax_converter_reads():
    """Each key carries its index into the converter; every leaf of the
    converted tree names the key it came from, so the keys it read, and
    where each went, are known.  The JAX layout of each port shape must be
    the JAX module's."""
    shapes = _full_keys()
    keys = sorted(shapes)
    tagged = {k: np.full((1,) * len(shapes[k]), i, np.float32)
              for i, k in enumerate(keys)}
    tree = _flat(convert_diffusers_vae(tagged))
    _, template = _jax_template()
    want = _flat(template)
    assert set(tree) == set(want)
    read = set()
    for path, leaf in tree.items():
        key = keys[int(np.asarray(leaf).flat[0])]
        read.add(key)
        # conv (O, I, kh, kw) -> (kh, kw, I, O); linear (O, I) -> (I, O)
        order = {4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}[len(shapes[key])]
        jax_shape = tuple(shapes[key][i] for i in order)
        assert jax_shape == want[path].shape, (key, path)
    assert read == set(keys)
    assert architecture({k: torch.empty(s, device="meta")
                         for k, s in shapes.items()}) == dict(
        ch=128, ch_mult=(1, 2, 4, 4), z_ch=4)


def test_load_vae_reads_a_state_dict(tmp_path):
    vae = seeded_vae(5, **SMALL)
    sd = vae.state_dict()
    path = tmp_path / "vae.pt"
    torch.save(sd, path)
    got = load_vae(str(path), "cpu")
    assert architecture(got.state_dict()) == dict(ch=32, ch_mult=(1, 2),
                                                  z_ch=4)
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # older files hold the attention projections as 1x1 convs
    old = {k: (v[:, :, None, None] if ".attentions." in k and v.ndim == 2
               else v) for k, v in sd.items()}
    torch.save(old, tmp_path / "old.bin")
    z = torch.randn(1, 4, 8, 8)
    with torch.no_grad():
        torch.testing.assert_close(
            load_vae(str(tmp_path / "old.bin"), "cpu").decode(z),
            vae.decode(z), rtol=0, atol=0)
    del sd["decoder.conv_out.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        load_vae(str(path), "cpu")


def test_load_vae_random_and_safetensors(tmp_path, monkeypatch):
    a = load_vae("random:3", "cpu")
    assert architecture(a.state_dict())["ch_mult"] == (1, 2, 4, 4)
    w = a.decoder.conv_out.weight
    assert torch.equal(w, load_vae("random:3", "cpu").decoder.conv_out.weight)
    assert not torch.equal(w, load_vae("random:4", "cpu").decoder
                           .conv_out.weight)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors"):
        load_vae(str(tmp_path / "vae.safetensors"), "cpu")
    if not torch.cuda.is_available():  # the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_vae("random")
