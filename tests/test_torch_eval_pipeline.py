"""The port's metric pipeline (`dimsum_torch/eval/metric_main.py`) against
the JAX package's on the same folders: 24 real and 24 generated PNGs
(written by the port's `write_png`), the randproj detector, and every
registered image metric but IS (which needs logits):

  * calc_metric per metric and calc_metrics_many (one shared detector
    pass) give JAX's FID to 1e-10 relative and JAX's KID, precision and
    recall exactly (identical fp32 features, the same subset RNG);
  * the real side's stats cache uses JAX's md5 key, so a cache written by
    one package is found by the other;
  * merge_feature_stats of contiguous slices equals one pass (moments to
    1e-12, raw features in order);
  * report_metric appends one JSON line a call.
"""

import json

import numpy as np
import pytest

import dimsum_torch.eval.metric_main as port
import dimsum_tpu.eval.metric_main as ref
from dimsum_torch.data import ImageFolderDataset
from dimsum_torch.eval import RandomProjectionDetector
from dimsum_torch.eval.dist_stats import merge_feature_stats
from dimsum_torch.eval.fid import FeatureStats
from dimsum_torch.utils.png import write_png
from dimsum_tpu.data import ImageFolderDataset as JaxImageFolder
from dimsum_tpu.eval.features import RandomProjectionDetector as JaxRandProj
from tests.test_torch_convert import torch_one_thread  # noqa: F401

METRICS = ["fid50k_full", "fid2k_full", "kid50k_full", "pr50k3_full"]


def make_folder(path, n, seed, size=32, shift=0):
    rng = np.random.default_rng(seed)
    path.mkdir()
    y, x = np.mgrid[:size, :size]
    for i in range(n):
        base = (x * (i % 5 + 1) + y * (i % 3) + shift) % 256
        img = base[..., None] + rng.integers(0, 60, (size, size, 3))
        write_png(str(path / f"{i:03d}.png"), np.clip(img, 0, 255).astype(
            np.uint8))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    make_folder(root / "real", 24, seed=1)
    make_folder(root / "gen", 24, seed=2, shift=40)
    return root


def _run(pkg, root, many: bool, cache):
    if pkg == "port":
        mod, folder, det = port, ImageFolderDataset, RandomProjectionDetector
    else:
        mod, folder, det = ref, JaxImageFolder, JaxRandProj
    real = folder(str(root / "real"), 32, raw_uint8=True)
    gen = folder(str(root / "gen"), 32, raw_uint8=True)

    def gen_batches():
        for i in range(0, len(gen), 8):
            yield np.stack([gen[j][0] for j in range(i, min(i + 8, 24))])

    opts = dict(real_dataset=real, gen_batches=gen_batches, detector=det(),
                batch_size=8, cache_dir=str(cache),
                dataset_id=str(root / "real"), detector_id="randproj")
    if pkg == "port":  # KID and PR run on the card unless asked for the CPU
        opts["device"] = "cpu"
    if many:
        out = mod.calc_metrics_many(METRICS, **opts)
    else:
        out = [mod.calc_metric(m, **opts) for m in METRICS]
    return {k: v for r in out for k, v in r["results"].items()}


@pytest.mark.parametrize("many", [False, True])
def test_metrics_equal_jax(folders, tmp_path, many):
    got = _run("port", folders, many, tmp_path / "port-cache")
    want = _run("jax", folders, many, tmp_path / "jax-cache")
    assert set(got) == set(want)
    assert want["fid50k_full"] > 1.0
    assert 0 < want["pr50k3_full_precision"] < 1 or \
        0 < want["pr50k3_full_recall"] < 1
    np.testing.assert_allclose(got["fid50k_full"], want["fid50k_full"],
                               rtol=1e-10)
    np.testing.assert_allclose(got["fid2k_full"], want["fid2k_full"],
                               rtol=1e-10)
    for k in ("kid50k_full", "pr50k3_full_precision",
              "pr50k3_full_recall"):
        assert got[k] == want[k], k
    names = sorted(p.name for p in (tmp_path / "port-cache").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax-cache")
                           .iterdir())


def test_cache_written_by_jax_is_read(folders, tmp_path):
    _run("jax", folders, True, tmp_path / "cache")
    calls = []

    class Counting(RandomProjectionDetector):
        def __call__(self, x):
            calls.append(len(x))
            return super().__call__(x)

    real = ImageFolderDataset(str(folders / "real"), 32, raw_uint8=True)
    stats = port.dataset_feature_stats(
        real, Counting(), 8, capture_all=True, cache_dir=str(tmp_path /
                                                             "cache"),
        dataset_id=str(folders / "real"), detector_id="randproj")
    assert calls == [] and stats.num_items == 24


def test_merge_of_slices_equals_one_pass():
    x = np.random.default_rng(0).standard_normal((97, 16)).astype(
        np.float32)
    single = FeatureStats(capture_all=True)
    single.append(x)
    parts = []
    for r in range(3):
        p = FeatureStats(capture_all=True)
        lo, hi = r * 97 // 3, (r + 1) * 97 // 3
        for i in range(lo, hi, 7):
            p.append(x[i:min(i + 7, hi)])
        parts.append(p)
    merged = merge_feature_stats(parts)
    np.testing.assert_array_equal(merged.get_all(), x)
    for a, b in zip(merged.get_mean_cov(), single.get_mean_cov()):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_report_metric_appends(tmp_path, capsys):
    for v in (1.0, 2.0):
        port.report_metric({"metric": "fid2k_full",
                            "results": {"fid2k_full": v}}, str(tmp_path))
    lines = (tmp_path / "metric-fid2k_full.jsonl").read_text().splitlines()
    assert [json.loads(s)["results"]["fid2k_full"] for s in lines] == \
        [1.0, 2.0]
    assert len(capsys.readouterr().out.splitlines()) == 2
    with pytest.raises(ValueError, match="unknown metric"):
        port.calc_metric("fid1k_full")
