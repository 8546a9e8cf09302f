"""Perceptual path length, `dimsum_torch/eval/ppl.py` against
`dimsum_tpu/eval/ppl.py`, and `python -m dimsum_torch.sample ODE
--compute-ppl` on the CPU:

  * slerp, the image preparation (crop, 2x2 downsampling of 512-px
    images, [0, 255], grey to RGB) and compute_ppl with one numpy
    sampler_fn / lpips_fn shared by both packages give JAX's values
    exactly, for every registered sampling (end, full) and crop, with and
    without labels;
  * the CLI (a narrow DiM, DiM-S/2 at 128 px, a small VAE, the
    random-lpips detector, 4 pairs) appends one finite, positive
    `ppl2_zend` to `metric-ppl2_zend.jsonl`, with and without CFG (CFG
    doubles the batch with the null class, so the two ends of a pair stay
    apart), and asks for --ppl-detector and --vae-ckpt.
"""

import json

import numpy as np
import pytest

from dimsum_torch import sample as cli
from dimsum_torch.eval import ppl as port
from dimsum_tpu.eval import ppl as ref
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_sample_cli import MODEL, files  # noqa: F401


def test_slerp_and_prep_equal_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 5, 12))
    t = rng.uniform(size=(5, 1))
    np.testing.assert_array_equal(port.slerp(a, b, t), ref.slerp(a, b, t))
    for shape, crop in (((2, 3, 64, 64), True), ((2, 1, 512, 512), False),
                        ((2, 3, 512, 512), True)):
        img = rng.uniform(-1, 1, shape)
        np.testing.assert_array_equal(port._prep_images(img, crop),
                                      ref._prep_images(img, crop))


def _sampler(z, y):
    """A deterministic numpy 'generator': z (N, 4, 4, 4) -> (N, 3, 32, 32)
    images in [-1, 1], labels shifting them."""
    w = np.random.default_rng(7).standard_normal((64, 3 * 32 * 32)) / 8
    out = np.tanh(z.reshape(len(z), -1) @ w)
    if y is not None:
        out = out + 0.01 * np.asarray(y)[:, None]
    return out.reshape(len(z), 3, 32, 32)


def _lpips(img):
    w = np.random.default_rng(8).standard_normal((img[0].size, 16)) / 100
    return img.reshape(len(img), -1) @ w


@pytest.mark.parametrize("sampling,crop,classes", [
    ("end", False, 0), ("end", True, 5), ("full", True, 0)])
def test_compute_ppl_equals_jax(sampling, crop, classes):
    kw = dict(sampler_fn=_sampler, lpips_fn=_lpips, z_shape=(4, 4, 4),
              num_samples=7, sampling=sampling, crop=crop, batch_size=3,
              num_classes=classes, seed=2)
    got = port.compute_ppl(**kw)
    assert np.isfinite(got) and got > 0
    assert got == ref.compute_ppl(**kw)


@pytest.mark.parametrize("cfg", ["1.0", "1.4"])
def test_sample_cli_compute_ppl(files, tmp_path, cfg):  # noqa: F811
    root, _, _ = files
    out = tmp_path / "ppl"
    rec = cli.main(["ODE", *MODEL, "--ckpt", str(root / "ckpt.pt"),
                    "--vae-ckpt", str(root / "vae.pt"), "--sampling-method",
                    "euler", "--num-sampling-steps", "3", "--cfg-scale", cfg,
                    "--global-batch-size", "4", "--compute-ppl", "ppl2_zend",
                    "--ppl-detector", "random-lpips:1", "--ppl-samples", "4",
                    "--sample-dir", str(out)])
    value = rec["ppl"]["results"]["ppl2_zend"]
    assert np.isfinite(value) and value > 0
    lines = (out / "metric-ppl2_zend.jsonl").read_text().splitlines()
    assert [json.loads(s)["results"]["ppl2_zend"] for s in lines] == [value]


def test_sample_cli_ppl_needs_its_files(files, tmp_path):  # noqa: F811
    root, _, _ = files
    argv = ["ODE", *MODEL, "--compute-ppl", "ppl2_zend", "--sample-dir",
            str(tmp_path)]
    with pytest.raises(SystemExit, match="ppl-detector"):
        cli.main(argv)
    with pytest.raises(SystemExit, match="vae-ckpt"):
        cli.main(argv + ["--ppl-detector", "random-lpips"])
