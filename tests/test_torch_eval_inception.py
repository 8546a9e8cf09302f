"""The port's FID InceptionV3 (`dimsum_torch/eval/inception.py`) against the
JAX package's flax one and against the independent torchvision-named
oracle of tests/test_inception.py:

  * the flax params of the JAX `jax-random` detector (`init` at seed 0,
    kernels x sqrt(2)), carried into the port by
    `utils.convert.inception_state_dict_from_flax`, give the same 2048
    features on 2 images at 299 px: max error / max |feature| < 1e-4
    (measured 1.5e-6 here, fp32 on both sides; the bound of
    tests/test_inception.py is 2e-3);
  * a torchvision-named state dict file (the oracle's, with fc.* and
    AuxLogits.* entries, with and without num_batches_tracked) loads
    strictly through `InceptionDetector.from_file` and gives the oracle's
    features (1e-5 of scale);
  * `preprocess_uint8` equals the JAX one at 64 and 256 px (1e-5) and
    `F.interpolate` at 512 px, where the JAX one (jax.image.resize, which
    antialiases when it shrinks) differs by more than 0.1 (measured
    0.537 on [0, 1] inputs);
  * the seeded random network gives the same weights on every call and
    discriminative features (the He scale).

The flax init is compiled once for the module (~17 s of its time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dimsum_torch.eval.inception import (InceptionDetector,
                                         InceptionV3Features,
                                         preprocess_uint8,
                                         random_init_inception_)
from dimsum_torch.utils.convert import inception_state_dict_from_flax
from dimsum_tpu.eval import inception as jax_inception
from tests.test_inception import TorchInceptionOracle, _randomize_bn
from tests.test_torch_convert import torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def flax_params():
    model = jax_inception.InceptionV3Features()
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 299, 299, 3)))["params"]
    # the JAX jax-random detector's He scale (eval/features.py:148-163)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a * jnp.sqrt(2.0)
                      if jax.tree_util.keystr(p).endswith("kernel']")
                      else a), params)
    return model, params


def test_features_match_flax(flax_params):
    model, params = flax_params
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 299, 299)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(
        params, jnp.transpose(jnp.asarray(x), (0, 2, 3, 1))))
    net = InceptionV3Features()
    net.load_state_dict(inception_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    scale = np.abs(want).max()
    assert want.std() > 0.1 * scale  # the He scale keeps features apart
    assert np.abs(got - want).max() / scale < 1e-4


@pytest.mark.parametrize("with_counter", [True, False])
def test_torchvision_named_file_loads_strictly(tmp_path, with_counter):
    gen = torch.Generator().manual_seed(0)
    oracle = TorchInceptionOracle().eval()
    _randomize_bn(oracle, gen)
    sd = dict(oracle.state_dict())
    if not with_counter:
        sd = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    torch.save(sd, tmp_path / "pt_inception.pth")
    det = InceptionDetector.from_file(str(tmp_path / "pt_inception.pth"),
                                      "cpu")
    x = np.random.default_rng(1).integers(0, 256, (2, 3, 299, 299),
                                          dtype=np.uint8)
    with torch.no_grad():
        want = oracle(preprocess_uint8(torch.from_numpy(x))).numpy()
    got = det(x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 256])
def test_preprocess_matches_jax(size):
    img = np.random.default_rng(size).integers(0, 256, (2, 3, size, size),
                                               dtype=np.uint8)
    got = preprocess_uint8(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_inception.preprocess_uint8(img)).transpose(
        0, 3, 1, 2)
    assert got.shape == (2, 3, 299, 299)
    assert np.abs(got - want).max() < 1e-5


def test_preprocess_follows_pytorch_fid_at_512():
    """pytorch-fid resizes without antialias; the JAX package's
    jax.image.resize antialiases when it shrinks.  The port follows the
    reference (ROADMAP Queue 3, kept by design)."""
    img = np.random.default_rng(512).integers(0, 256, (2, 3, 512, 512),
                                              dtype=np.uint8)
    t = torch.from_numpy(img)
    got = preprocess_uint8(t)
    want = 2 * F.interpolate(t.float() / 255, size=(299, 299),
                             mode="bilinear", align_corners=False) - 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jax_out = np.asarray(jax_inception.preprocess_uint8(img)).transpose(
        0, 3, 1, 2)
    # on [0, 1] the two differ by half of this
    assert np.abs(got.numpy() - jax_out).max() / 2 > 0.1


def test_random_network_is_seeded():
    a = random_init_inception_(InceptionV3Features(), 0).state_dict()
    b = random_init_inception_(InceptionV3Features(), 0).state_dict()
    c = random_init_inception_(InceptionV3Features(), 1).state_dict()
    w = "Mixed_6b.branch7x7_2.conv.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[w], c[w])
    # He scale: variance 2 / fan_in
    fan = a[w][0].numel()
    np.testing.assert_allclose(a[w].var().item(), 2 / fan, rtol=0.05)
    var = a["Mixed_6b.branch7x7_2.bn.running_var"]
    assert var.shape == (128,) and torch.equal(var, torch.ones(128))
