"""Metric registry and the calc_metric front end, port of
`dimsum_tpu/eval/metric_main.py` (the reference's metric_main.py registry
and metric_utils' on-disk stats cache keyed by dataset and detector).

opts of every metric:
  real_dataset  map-style dataset of uint8 NCHW images (item [0])
  gen_batches   zero-argument callable yielding uint8 NCHW batches
  detector      callable uint8 NCHW -> (B, F) features
  gen_stats / real_stats   precomputed FeatureStats, shared by metrics
  cache_dir / dataset_id / detector_id / batch_size
  device        where KID's and precision/recall's products run: the card
                unless "cpu" is given ("auto": the torch route on a CUDA
                device, numpy on the CPU)
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from dimsum_torch.eval.dist_stats import combine_feature_stats, world
from dimsum_torch.eval.features import batched_features
from dimsum_torch.eval.fid import (FeatureStats, compute_fid,
                                   compute_inception_score, compute_kid,
                                   compute_precision_recall)

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn):
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics():
    return list(_metric_dict)


def _dataset_batches(dataset, batch_size: int, max_items: Optional[int],
                     shard=(0, 1)):
    """Batches over this process's CONTIGUOUS shard of the dataset (the
    reference strides the ranks; contiguous blocks cover the same items
    and concatenate in rank order into the one-process order)."""
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    rank, size = shard
    lo, hi = rank * n // size, (rank + 1) * n // size
    for i in range(lo, hi, batch_size):
        xs = [dataset[j][0] for j in range(i, min(i + batch_size, hi))]
        yield np.stack(xs)


def _cache_path(cache_dir, tag, dataset_id, detector_id, max_items,
                capture_all=False):
    key = json.dumps([dataset_id, detector_id, max_items, capture_all],
                     sort_keys=True)
    md5 = hashlib.md5(key.encode()).hexdigest()
    return os.path.join(cache_dir, f"{tag}-{md5}.npz")


def dataset_feature_stats(dataset, detector, batch_size: int = 64,
                          max_items: Optional[int] = None,
                          capture_all: bool = False,
                          cache_dir: Optional[str] = None,
                          dataset_id: str = "", detector_id: str = "",
                          shard=None):
    """Features of the real dataset, cached on disk as metric_utils does.

    With `shard=(rank, world)`, world > 1: COLLECTIVE -- each process runs
    the detector over its own contiguous shard, the stats are combined
    over the process group (every rank returns the whole dataset's; rank 0
    writes the cache)."""
    rank, size = shard if shard is not None else (0, 1)
    path = None
    if cache_dir:
        if rank == 0:
            os.makedirs(cache_dir, exist_ok=True)
        path = _cache_path(cache_dir, "real-stats", dataset_id, detector_id,
                           max_items, capture_all)
        if os.path.exists(path):
            loaded = FeatureStats.load(path)
            if not capture_all or loaded.capture_all:
                return loaded
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=True)
    batched_features(
        _dataset_batches(dataset, batch_size, max_items, (rank, size)),
        detector, stats)
    if size > 1:
        stats = combine_feature_stats(stats)
    if path and rank == 0:
        stats.save(path)
    return stats


def gen_feature_stats(gen_batches: Iterable, detector,
                      max_items: Optional[int] = None,
                      capture_all: bool = False) -> FeatureStats:
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=True,
                         max_items=max_items)
    return batched_features(gen_batches, detector, stats)


def _real_stats(opts, capture_all: bool = False):
    """The real side's stats: the caller's precomputed ones
    (opts["real_stats"], e.g. calc_metrics_multiprocess's sharded ones:
    metrics may run on rank 0 alone, so no collective hides in them) or a
    pass of the detector over the dataset."""
    rs = opts.get("real_stats")
    if rs is not None and (not capture_all or rs.capture_all):
        return rs
    return dataset_feature_stats(opts["real_dataset"], opts["detector"],
                                 opts.get("batch_size", 64),
                                 max_items=None, capture_all=capture_all,
                                 cache_dir=opts.get("cache_dir"),
                                 dataset_id=opts.get("dataset_id", ""),
                                 detector_id=opts.get("detector_id", ""))


def _gen_stats(opts, n: Optional[int], capture_all: bool = False):
    """The generated side's stats: the caller's shared ones
    (opts["gen_stats"], one detector pass for several metrics) or a pass
    over the generator."""
    gs = opts.get("gen_stats")
    if gs is not None and (not capture_all or gs.capture_all):
        return gs
    return gen_feature_stats(opts["gen_batches"](), opts["detector"],
                             max_items=n, capture_all=capture_all)


@register_metric
def fid50k_full(opts):
    return {"fid50k_full": _fid(opts, 50_000)}


@register_metric
def fid10k_full(opts):
    return {"fid10k_full": _fid(opts, 10_000)}


@register_metric
def fid5k_full(opts):
    return {"fid5k_full": _fid(opts, 5_000)}


@register_metric
def fid2k_full(opts):
    return {"fid2k_full": _fid(opts, 2_000)}


@register_metric
def kid50k_full(opts):
    real = _real_stats(opts, capture_all=True)
    gen = _gen_stats(opts, 50_000, capture_all=True)
    return {"kid50k_full": compute_kid(real.get_all(), gen.get_all(),
                                       device=opts.get("device", "cuda"))}


@register_metric
def pr50k3_full(opts):
    real = _real_stats(opts, capture_all=True)
    gen = _gen_stats(opts, 50_000, capture_all=True)
    p, r = compute_precision_recall(real.get_all(), gen.get_all(),
                                    device=opts.get("device", "cuda"))
    return {"pr50k3_full_precision": p, "pr50k3_full_recall": r}


@register_metric
def is50k(opts):
    gen = _gen_stats(opts, 50_000, capture_all=True)
    logits = gen.get_all()
    # the detector gives logits (the reference runs the network with
    # no_output_bias=True and softmaxes, inception_score.py)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    mean, std = compute_inception_score(probs)
    return {"is50k_mean": mean, "is50k_std": std}


def _ppl(opts, sampling: str, crop: bool, num_samples: int) -> float:
    from dimsum_torch.eval.ppl import compute_ppl

    return compute_ppl(
        sampler_fn=opts["sampler_fn"], lpips_fn=opts["lpips_fn"],
        z_shape=opts["z_shape"],
        num_samples=opts.get("num_samples", num_samples),
        epsilon=1e-4, sampling=sampling, crop=crop,
        batch_size=opts.get("batch_size", 2),
        num_classes=opts.get("num_classes", 0),
        seed=opts.get("seed", 0))


@register_metric
def ppl2_zend(opts):
    """The reference's headline ppl2_wend (metric_main.py:151-155) in the
    diffusion latent space: 50k samples, endpoints, no crop."""
    return {"ppl2_zend": _ppl(opts, "end", False, 50_000)}


@register_metric
def ppl_zend(opts):
    return {"ppl_zend": _ppl(opts, "end", True, 50_000)}


@register_metric
def ppl_zfull(opts):
    return {"ppl_zfull": _ppl(opts, "full", True, 50_000)}


def _fid(opts, n: int) -> float:
    real = _real_stats(opts)
    gen = _gen_stats(opts, n)
    return compute_fid(real, gen)


def _checked(metrics):
    metrics = [m.strip() for m in metrics if m.strip()]
    for m in metrics:
        if not is_valid_metric(m):
            raise ValueError(f"unknown metric {m!r}; valid: "
                             f"{list_valid_metrics()}")
    return metrics


def calc_metric(metric: str, **opts) -> Dict:
    """Run one registered metric (opts: the module's docstring)."""
    _checked([metric])
    t0 = time.time()
    results = _metric_dict[metric](opts)
    return dict(metric=metric, results=results,
                total_time=time.time() - t0)


def calc_metrics_many(metrics, **opts):
    """Several metrics over ONE pass of the generator and detector: the
    generated images stream into one shared FeatureStats (capture_all
    when a metric needs raw features), which every metric reads."""
    metrics = _checked(metrics)
    need_all = any(not m.startswith("fid") for m in metrics)
    if "gen_stats" not in opts and opts.get("gen_batches") is not None:
        opts["gen_stats"] = gen_feature_stats(
            opts["gen_batches"](), opts["detector"],
            max_items=opts.get("max_gen_items"), capture_all=need_all)
    return [calc_metric(m, **opts) for m in metrics]


def calc_metrics_multiprocess(metrics, real_dataset, detector,
                              gen_batches=None, gen_stats=None,
                              max_gen_items: Optional[int] = None,
                              **opts):
    """The rank-sharded metric pipeline over the default process group:

      1. every process streams ITS OWN generated batches through the
         detector (`gen_batches` yields this rank's slice; `max_gen_items`
         caps the local count), or passes its partial `gen_stats`;
      2. the partial stats are combined over the group;
      3. every process runs the detector over its contiguous shard of the
         real dataset (none on a stats-cache hit), combined likewise;
      4. rank 0 computes the metrics and returns the results; the other
         ranks return [].

    COLLECTIVE: every process calls it with the same metric list.  One
    process: calc_metrics_many."""
    rank, size = world()
    metrics = _checked(metrics)
    need_all = any(not m.startswith("fid") for m in metrics)

    if gen_stats is None and gen_batches is not None:
        gen_stats = gen_feature_stats(gen_batches(), detector,
                                      max_items=max_gen_items,
                                      capture_all=need_all)
    if size > 1 and gen_stats is not None:
        gen_stats = combine_feature_stats(gen_stats)

    real_stats = dataset_feature_stats(
        real_dataset, detector, opts.get("batch_size", 64),
        max_items=None, capture_all=need_all,
        cache_dir=opts.get("cache_dir"),
        dataset_id=opts.get("dataset_id", ""),
        detector_id=opts.get("detector_id", ""),
        shard=(rank, size))

    if rank != 0:
        return []
    return [calc_metric(m, real_dataset=real_dataset, detector=detector,
                        gen_stats=gen_stats, real_stats=real_stats, **opts)
            for m in metrics]


def report_metric(result: Dict, run_dir: Optional[str] = None):
    """Print the result as one JSON line and append it to
    `run_dir/metric-<name>.jsonl`."""
    line = json.dumps(result)
    print(line)
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(
                run_dir, f"metric-{result['metric']}.jsonl"), "a") as f:
            f.write(line + "\n")
