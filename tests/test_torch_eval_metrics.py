"""The port's metric math (`dimsum_torch/eval/fid.py`) against the JAX
package's (`dimsum_tpu/eval/fid.py`) on seeded numpy features:

  * FeatureStats streamed in batches equals one pass over all rows, with
    and without a cap, and a stats cache written by either package is read
    by the other with the same contents;
  * the Frechet distance, FID and the Inception Score equal JAX's to 1e-10
    relative (the same fp64 host math);
  * KID and precision/recall by impl="numpy" equal JAX's exactly; by
    impl="torch" on the CPU device they match "numpy" at the shapes of
    tests/test_pr_jax.py, PR to 1e-9 absolute (equal but for pairs within
    fp32 rounding of a radius), KID to 1e-6 relative (measured 6.9e-8:
    the torch route's products are fp32, its kernel sums fp64); the PR
    result does not depend on the row chunk;
  * impl="auto" is "numpy" on the CPU device and "torch" on a CUDA one.
"""

import numpy as np
import pytest
import torch

from dimsum_torch.eval import fid as port
from dimsum_tpu.eval import fid as ref
from tests.test_torch_convert import torch_one_thread  # noqa: F401


def _feats(seed, n, d, shift=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, d)) + shift).astype(np.float32)


@pytest.mark.parametrize("max_items", [None, 50])
def test_feature_stats_streaming_equals_direct(max_items):
    x = _feats(0, 77, 12)
    streamed = port.FeatureStats(capture_all=True, max_items=max_items)
    for i in range(0, 77, 10):
        streamed.append(x[i:i + 10])
    want = x[:max_items] if max_items else x
    direct = port.FeatureStats(capture_all=True)
    direct.append(want)
    assert streamed.num_items == len(want)
    np.testing.assert_array_equal(streamed.get_all(), want)
    mu, cov = streamed.get_mean_cov()
    mu_d, cov_d = direct.get_mean_cov()
    np.testing.assert_allclose(mu, mu_d, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cov, cov_d, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(mu, want.astype(np.float64).mean(0),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cov, np.cov(want.astype(np.float64).T,
                                           bias=True), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stats_cache_is_shared_with_jax(writer, tmp_path):
    x = _feats(1, 40, 8)
    mod_w, mod_r = (ref, port) if writer == "jax" else (port, ref)
    stats = mod_w.FeatureStats(capture_all=True)
    stats.append(x)
    path = str(tmp_path / "stats.npz")
    stats.save(path)
    back = mod_r.FeatureStats.load(path)
    assert back.num_items == 40 and back.capture_all
    np.testing.assert_array_equal(back.raw_mean, stats.raw_mean)
    np.testing.assert_array_equal(back.raw_cov, stats.raw_cov)
    np.testing.assert_array_equal(back.get_all(), x)


def test_fid_and_frechet_distance_match_jax():
    real, gen = _feats(2, 300, 16), _feats(3, 280, 16, 0.3, 1.2)
    stats = {}
    for name, mod in (("port", port), ("jax", ref)):
        r, g = mod.FeatureStats(), mod.FeatureStats()
        r.append(real)
        g.append(gen)
        stats[name] = (r, g, mod.compute_fid(r, g))
    got, want = stats["port"][2], stats["jax"][2]
    assert want > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-10)
    mu1, s1 = stats["port"][0].get_mean_cov()
    mu2, s2 = stats["port"][1].get_mean_cov()
    np.testing.assert_allclose(port.frechet_distance(mu1, s1, mu2, s2),
                               ref.frechet_distance(mu1, s1, mu2, s2),
                               rtol=1e-10)


def test_inception_score_matches_jax():
    logits = _feats(4, 103, 10, scale=2.0).astype(np.float64)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (1, 10, 200):
        got = port.compute_inception_score(probs, splits)
        want = ref.compute_inception_score(probs, splits)
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_kid_and_pr_numpy_equal_jax():
    real, gen = _feats(5, 310, 24), _feats(6, 260, 24, 0.4, 0.9)
    kw = dict(num_subsets=7, max_subset_size=120, seed=3)
    assert (port.compute_kid(real, gen, impl="numpy", device="cpu", **kw)
            == ref.compute_kid(real, gen, impl="numpy", **kw))
    assert (port.compute_precision_recall(real, gen, impl="numpy",
                                          row_batch=100, device="cpu")
            == ref.compute_precision_recall(real, gen, impl="numpy",
                                            row_batch=100))


def test_pr_torch_matches_numpy():
    # the shapes and clouds of tests/test_pr_jax.py
    rng = np.random.default_rng(0)
    real = rng.standard_normal((1203, 48)).astype(np.float32)
    gen = (0.8 * rng.standard_normal((911, 48)) + 0.7).astype(np.float32)
    p_np, r_np = port.compute_precision_recall(real, gen, impl="numpy",
                                               device="cpu")
    p_t, r_t = port.compute_precision_recall(real, gen, impl="torch",
                                             row_batch=256, device="cpu")
    assert 0.0 < p_np < 1.0 and 0.0 < r_np < 1.0
    assert abs(p_t - p_np) < 1e-9, (p_t, p_np)
    assert abs(r_t - r_np) < 1e-9, (r_t, r_np)


def test_pr_torch_row_chunking_invariance():
    rng = np.random.default_rng(1)
    real = rng.standard_normal((300, 16)).astype(np.float32)
    gen = rng.standard_normal((257, 16)).astype(np.float32) + 0.3
    a = port.compute_precision_recall(real, gen, impl="torch", row_batch=64,
                                      device="cpu")
    b = port.compute_precision_recall(real, gen, impl="torch",
                                      row_batch=10_000, device="cpu")
    assert a == b


def test_kid_torch_matches_numpy():
    rng = np.random.default_rng(3)
    real = rng.standard_normal((700, 64)).astype(np.float32)
    gen = (rng.standard_normal((650, 64)) * 1.1 + 0.2).astype(np.float32)
    kw = dict(num_subsets=20, max_subset_size=300)
    k_np = port.compute_kid(real, gen, impl="numpy", device="cpu", **kw)
    k_t = port.compute_kid(real, gen, impl="torch", device="cpu", **kw)
    assert k_np > 0.01
    assert abs(k_t - k_np) <= 1e-6 * abs(k_np), (k_t, k_np)


def test_auto_follows_the_device(monkeypatch):
    called = []
    monkeypatch.setattr(port, "_pr_torch",
                        lambda *a: called.append(a[-1]) or (0.0, 0.0))
    real, gen = _feats(7, 20, 4), _feats(8, 20, 4)
    port.compute_precision_recall(real, gen, device="cpu")
    assert called == []
    port.compute_precision_recall(real, gen, device="cuda")
    assert called == ["cuda"]
    with pytest.raises(ValueError, match="impl"):
        port.compute_kid(real, gen, impl="jax")


def test_default_device_is_the_card(monkeypatch):
    """KID, precision/recall, RandomLPIPS and metric_main's KID / PR run on
    the card unless device="cpu" is given: without a card the default
    raises, as `resolve_device` does, and never falls back to the CPU."""
    import inspect

    from dimsum_torch.eval import features, metric_main

    for fn in (port.compute_kid, port.compute_precision_recall):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(
        features.RandomLPIPS).parameters["device"].default == "cuda"
    real, gen = _feats(9, 40, 8), _feats(10, 40, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.compute_kid(real, gen, num_subsets=2, max_subset_size=20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.compute_precision_recall(real, gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        features.RandomLPIPS(seed=0)
    seen = []
    monkeypatch.setattr(metric_main, "compute_kid",
                        lambda *a, **kw: seen.append(kw["device"]) or 0.0)
    monkeypatch.setattr(metric_main, "compute_precision_recall",
                        lambda *a, **kw: seen.append(kw["device"]) or (0, 0))
    stats = port.FeatureStats(capture_all=True)
    stats.append(gen)
    monkeypatch.setattr(metric_main, "_real_stats", lambda o, **kw: stats)
    monkeypatch.setattr(metric_main, "_gen_stats", lambda o, n, **kw: stats)
    metric_main.kid50k_full({})
    metric_main.pr50k3_full({})
    metric_main.kid50k_full({"device": "cpu"})
    assert seen == ["cuda", "cuda", "cpu"]
