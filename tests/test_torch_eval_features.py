"""The port's detectors (`dimsum_torch/eval/features.py`) against the JAX
package's (`dimsum_tpu/eval/features.py`):

  * RandomProjectionDetector gives JAX's features bit for bit, from numpy
    images and from uint8 tensors;
  * RandomLPIPS with JAX's weights carried in (HWIO -> OIHW) gives JAX's
    embeddings to 1e-5 of their scale, at sizes where "SAME" padding is
    uneven; its own seeded weights have the He scale;
  * make_detector / detector_id / make_lpips for every spec: None and
    randproj, jax-random and inception-random (the port's id
    "torch-random-he", never JAX's "jax-random-he"), jax:<pth> and
    inception:<pth>, a TorchScript file (called with the reference's
    keyword arguments), random-lpips[:seed];
  * latents_to_uint8 truncates as JAX's does, on numpy and on tensors;
  * batched_features stops at the cap.
"""

import numpy as np
import pytest
import torch

import dimsum_torch.eval.features as port
import dimsum_tpu.eval.features as ref
from dimsum_torch.eval.inception import InceptionDetector
from tests.test_torch_convert import torch_one_thread  # noqa: F401


def _images(seed, n=3, h=40, w=44):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, h, w),
                                                dtype=np.uint8)


def test_random_projection_bit_for_bit():
    x = _images(0)
    want = ref.RandomProjectionDetector()(x)
    np.testing.assert_array_equal(port.RandomProjectionDetector()(x), want)
    np.testing.assert_array_equal(
        port.RandomProjectionDetector()(torch.from_numpy(x)), want)


def _jax_lpips_weights(seed, channels, num_features=128):
    """The JAX RandomLPIPS._build draws (features.py:82-95)."""
    import jax

    ks = jax.random.split(jax.random.PRNGKey(seed), 4)

    def he(k, shape, fan):
        return np.asarray(jax.random.normal(k, shape)) * np.sqrt(2.0 / fan)

    return [he(ks[0], (5, 5, channels, 32), 5 * 5 * channels),
            he(ks[1], (3, 3, 32, 64), 3 * 3 * 32),
            he(ks[2], (3, 3, 64, 128), 3 * 3 * 64),
            he(ks[3], (256, num_features), 256)]


@pytest.mark.parametrize("hw", [(64, 64), (67, 61)])
def test_random_lpips_matches_jax(hw):
    x = np.random.default_rng(1).uniform(0, 255, (2, 3, *hw)).astype(
        np.float32)
    want = ref.RandomLPIPS(seed=2)(x)
    lp = port.RandomLPIPS(seed=2, device="cpu")
    ws = _jax_lpips_weights(2, 3)
    lp.weights = [torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 2, 0, 1))).float() for w in ws[:3]]
    lp.weights.append(torch.from_numpy(ws[3]).float())
    got = lp(x)
    assert got.shape == (2, 128)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_random_lpips_own_weights():
    x = np.random.default_rng(3).uniform(0, 255, (2, 3, 32, 32))
    a, b = (port.RandomLPIPS(seed=0, device="cpu"),
            port.RandomLPIPS(seed=0, device="cpu"))
    np.testing.assert_array_equal(a(x), b(x))
    w = a.weights[1]
    assert w.shape == (64, 32, 3, 3)
    np.testing.assert_allclose(w.var().item(), 2 / (9 * 32), rtol=0.1)
    assert not np.array_equal(port.RandomLPIPS(seed=1, device="cpu")(x), a(x))


class _Scripted(torch.nn.Module):
    def forward(self, x: torch.Tensor, return_features: bool = False,
                resize_images: bool = True, return_lpips: bool = False):
        out = x.float().mean(dim=(2, 3))
        if return_features:
            out = out * 2
        if return_lpips and not resize_images:
            out = out + 1
        return out


def test_make_detector_every_spec(tmp_path):
    assert isinstance(port.make_detector(None),
                      port.RandomProjectionDetector)
    assert isinstance(port.make_detector("randproj"),
                      port.RandomProjectionDetector)
    assert port.detector_id(None) == port.detector_id("randproj") \
        == ref.detector_id(None) == "randproj"

    for spec in ("jax-random", "inception-random"):
        det = port.make_detector(spec, "cpu")
        assert isinstance(det, InceptionDetector)
        assert det.device == torch.device("cpu")
        assert port.detector_id(spec) == "torch-random-he"
    assert ref.detector_id("jax-random") == "jax-random-he"
    w = "Mixed_5b.branch1x1.conv.weight"
    assert torch.equal(port.make_detector("jax-random", "cpu").model
                       .state_dict()[w],
                       port.make_detector("inception-random", "cpu").model
                       .state_dict()[w])

    pth = tmp_path / "inc.pth"
    torch.save(port.make_detector("jax-random", "cpu").model.state_dict(),
               pth)
    for spec in (f"jax:{pth}", f"inception:{pth}"):
        det = port.make_detector(spec, "cpu")
        assert isinstance(det, InceptionDetector)
        assert torch.equal(det.model.state_dict()[w],
                           torch.load(pth)[w])
        assert port.detector_id(spec) == f"inception:{pth}"

    ts = tmp_path / "detector.pt"
    torch.jit.save(torch.jit.script(_Scripted()), str(ts))
    x = _images(4)
    det = port.make_detector(str(ts), "cpu")
    assert isinstance(det, port.TorchScriptDetector)
    np.testing.assert_allclose(det(x), 2 * x.astype(np.float32).mean((2, 3)),
                               rtol=1e-6)
    assert port.detector_id(str(ts)) == str(ts)
    lp = port.make_lpips(str(ts), "cpu")
    np.testing.assert_allclose(lp(x), x.astype(np.float32).mean((2, 3)) + 1,
                               rtol=1e-6)
    with pytest.raises(FileNotFoundError, match="not found"):
        port.make_detector(str(tmp_path / "missing.pt"), "cpu")

    for spec, seed in (("random-lpips", 0), ("random-lpips:5", 5)):
        lp = port.make_lpips(spec, "cpu")
        assert isinstance(lp, port.RandomLPIPS) and lp.seed == seed


def test_latents_to_uint8_truncates_as_jax():
    x = np.random.default_rng(5).uniform(-1.2, 1.2, (2, 3, 9, 7)).astype(
        np.float32)
    want = ref.latents_to_uint8(x)
    np.testing.assert_array_equal(port.latents_to_uint8(x), want)
    got = port.latents_to_uint8(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_features_stops_at_the_cap():
    det = port.RandomProjectionDetector()
    batches = [_images(i, n=4) for i in range(5)]
    stats = port.batched_features(iter(batches), det, max_items=10)
    assert stats.num_items == 10
    want = ref.batched_features(iter(batches),
                                ref.RandomProjectionDetector(),
                                max_items=10)
    np.testing.assert_array_equal(stats.raw_mean, want.raw_mean)
