"""Metric math, port of `dimsum_tpu/eval/fid.py`: FID, KID, the Inception
Score and improved precision/recall (the StyleGAN-ADA metric suite of the
reference's eval toolbox).

`FeatureStats` keeps the streaming moments on the host in fp64 and saves
them in the JAX package's `.npz` layout, so a stats cache written by either
package is read by the other.  KID and precision/recall take `impl`:

  * "numpy": the reference math verbatim (the JAX package's numpy route);
  * "torch": the products on `device` in fp32 with TF32 off (the JAX
    route's precision="highest"): KID's subsets drawn on the host from the
    same RNG stream as the numpy route, precision/recall's distances in
    row chunks of at most 4096 with `torch.topk` for the k-th neighbour;
  * "auto": "torch" when `device` is a CUDA device, else "numpy".

The device is the caller's, the card by default (`utils/device.py::
resolve_device`: it raises where there is none); the CPU runs them only
when asked for with device="cpu".  Nothing here reads it from the
environment.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from dimsum_torch.utils.device import resolve_device

ROW_CHUNK = 4096  # rows of a distance chunk on the device


class FeatureStats:
    """Streaming feature statistics: raw mean/cov accumulators and an
    optional capped store of raw features (for KID/PR)."""

    def __init__(self, capture_all: bool = False,
                 capture_mean_cov: bool = True,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is None:
            self.num_features = num_features
            self.raw_mean = np.zeros(num_features, np.float64)
            self.raw_cov = np.zeros((num_features, num_features), np.float64)
        elif num_features != self.num_features:
            raise ValueError(f"{num_features} features, expected "
                             f"{self.num_features}")

    def is_full(self) -> bool:
        return (self.max_items is not None
                and self.num_items >= self.max_items)

    def append(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"features must be (N, F), got {x.shape}")
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        if not self.capture_all:
            raise ValueError("these stats keep no raw features")
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        if not (self.capture_mean_cov and self.num_items > 0):
            raise ValueError("no moments accumulated")
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path: str):
        state = dict(num_items=self.num_items,
                     raw_mean=self.raw_mean, raw_cov=self.raw_cov,
                     capture_all=self.capture_all)
        if self.capture_all:
            state["all_features"] = self.get_all()
        np.savez_compressed(path, **state)

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        data = np.load(path, allow_pickle=True)
        obj = cls(capture_all=bool(data["capture_all"]))
        obj.num_items = int(data["num_items"])
        obj.raw_mean = data["raw_mean"]
        obj.raw_cov = data["raw_cov"]
        obj.num_features = obj.raw_mean.shape[0]
        if obj.capture_all and "all_features" in data:
            obj.all_features = [data["all_features"]]
        return obj


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between two Gaussians (the reference's
    frechet_inception_distance.py:52-58)."""
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    fid = m + np.trace(sigma1 + sigma2 - s * 2)
    return float(np.real(fid))


def compute_fid(stats_real: FeatureStats, stats_gen: FeatureStats) -> float:
    mu_r, sig_r = stats_real.get_mean_cov()
    mu_g, sig_g = stats_gen.get_mean_cov()
    return frechet_distance(mu_g, sig_g, mu_r, sig_r)


@contextlib.contextmanager
def no_tf32():
    """fp32 products and convolutions in full fp32 on the card (cuDNN's
    default runs fp32 convolutions as TF32), the previous flags restored
    after."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _impl(impl: str, device) -> str:
    if impl == "auto":
        return "torch" if torch.device(device).type == "cuda" else "numpy"
    if impl not in ("numpy", "torch"):
        raise ValueError(f"impl must be auto, numpy or torch, got {impl!r}")
    return impl


def compute_kid(feats_real: np.ndarray, feats_gen: np.ndarray,
                num_subsets: int = 100, max_subset_size: int = 1000,
                seed: int = 0, impl: str = "auto",
                device="cuda") -> float:
    """Kernel Inception Distance (the reference's
    kernel_inception_distance.py): the polynomial kernel (x.y/d + 1)^3
    averaged over random subsets.  Both routes draw the subsets from one
    host RNG stream (the generated rows, then the real ones, a subset);
    "torch" computes each subset's three m x m products on `device` in
    fp32, the kernel and its sums there in fp64 (fp32 sums in another
    order than numpy's drift by ~6e-7 of KID at m 300), and sums the
    subset terms on the host in fp64, as the numpy route does."""
    impl = _impl(impl, device)
    rng = np.random.default_rng(seed)
    n = feats_real.shape[1]
    m = min(min(feats_real.shape[0], feats_gen.shape[0]), max_subset_size)

    if impl == "torch":
        device = resolve_device(device)
        xis, yis = [], []
        for _ in range(num_subsets):
            xis.append(rng.choice(feats_gen.shape[0], m, replace=False))
            yis.append(rng.choice(feats_real.shape[0], m, replace=False))
        with torch.no_grad(), no_tf32():
            gen = torch.as_tensor(np.asarray(feats_gen, np.float32),
                                  device=device)
            real = torch.as_tensor(np.asarray(feats_real, np.float32),
                                   device=device)

            def kernel(p):  # the fp32 product, the rest in fp64
                return (p.double() / n + 1) ** 3

            terms = []
            for xi, yi in zip(xis, yis):
                x = gen[torch.as_tensor(xi, device=device)]
                y = real[torch.as_tensor(yi, device=device)]
                a = kernel(x @ x.T) + kernel(y @ y.T)
                b = kernel(x @ y.T)
                terms.append((a.sum() - torch.trace(a)) / (m - 1)
                             - b.sum() * 2 / m)
            terms = torch.stack(terms).cpu().numpy()
        return float(terms.astype(np.float64).sum() / num_subsets / m)

    t = 0.0
    for _ in range(num_subsets):
        x = feats_gen[rng.choice(feats_gen.shape[0], m, replace=False)]
        y = feats_real[rng.choice(feats_real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def compute_inception_score(probs: np.ndarray, num_splits: int = 10):
    """IS from softmax probabilities (the reference's inception_score.py)."""
    scores = []
    n = probs.shape[0]
    num_splits = max(1, min(num_splits, n))  # no empty split
    for i in range(num_splits):
        part = probs[i * n // num_splits: (i + 1) * n // num_splits]
        kl = part * (np.log(part + 1e-12)
                     - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aa = np.sum(a ** 2, axis=1, keepdims=True)
    bb = np.sum(b ** 2, axis=1, keepdims=True)
    return np.maximum(aa - 2 * a @ b.T + bb.T, 0.0)


def compute_precision_recall(feats_real: np.ndarray, feats_gen: np.ndarray,
                             nhood_size: int = 3,
                             row_batch: int = 10000,
                             impl: str = "auto", device="cuda"):
    """Improved precision & recall (the reference's precision_recall.py):
    membership of the other set's k-NN manifold in feature space.

    "numpy" is the reference math (row-batched distance matrices and a
    full sort on the host); "torch" computes the distances on `device` in
    fp32 in chunks of min(row_batch, 4096) rows, the k-th neighbour by
    `torch.topk` and the hit tests there too."""
    impl = _impl(impl, device)
    if impl == "torch":
        return _pr_torch(feats_real, feats_gen, nhood_size,
                         min(row_batch, ROW_CHUNK), device)

    def manifold_radii(feats):
        radii = np.zeros(feats.shape[0], np.float64)
        for i in range(0, feats.shape[0], row_batch):
            d = _pairwise_sq_dists(feats[i: i + row_batch], feats)
            # the k-th smallest leaving out the row itself (distance 0)
            radii[i: i + row_batch] = np.sort(d, axis=1)[:, nhood_size]
        return radii

    def fraction_in_manifold(probes, ref_feats, ref_radii):
        hits = np.zeros(probes.shape[0], bool)
        for i in range(0, probes.shape[0], row_batch):
            d = _pairwise_sq_dists(probes[i: i + row_batch], ref_feats)
            hits[i: i + row_batch] = np.any(d <= ref_radii[None, :], axis=1)
        return float(hits.mean())

    precision = fraction_in_manifold(feats_gen, feats_real,
                                     manifold_radii(feats_real))
    recall = fraction_in_manifold(feats_real, feats_gen,
                                  manifold_radii(feats_gen))
    return precision, recall


def _sq_dists(rows: torch.Tensor, feats: torch.Tensor,
              feats_sq: torch.Tensor) -> torch.Tensor:
    d = ((rows ** 2).sum(1, keepdim=True) - 2.0 * rows @ feats.T
         + feats_sq[None, :])
    return d.clamp_min(0.0)


@torch.no_grad()
def _pr_torch(feats_real, feats_gen, nhood_size: int, row_batch: int,
              device):
    device = resolve_device(device)
    with no_tf32():
        real = torch.as_tensor(np.asarray(feats_real, np.float32),
                               device=device)
        gen = torch.as_tensor(np.asarray(feats_gen, np.float32),
                              device=device)

        def manifold_radii(feats):
            sq = (feats ** 2).sum(1)
            return torch.cat([
                torch.topk(_sq_dists(feats[i:i + row_batch], feats, sq),
                           nhood_size + 1, dim=1, largest=False,
                           sorted=True).values[:, nhood_size]
                for i in range(0, feats.shape[0], row_batch)])

        def fraction(probes, ref, ref_radii):
            sq = (ref ** 2).sum(1)
            hits = torch.cat([
                (_sq_dists(probes[i:i + row_batch], ref, sq)
                 <= ref_radii[None, :]).any(1)
                for i in range(0, probes.shape[0], row_batch)])
            return float(hits.double().mean().item())

        precision = fraction(gen, real, manifold_radii(real))
        recall = fraction(real, gen, manifold_radii(gen))
    return precision, recall
