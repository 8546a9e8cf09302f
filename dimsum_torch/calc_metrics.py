"""Metrics over two image folders, the port of the top-level
`calc_metrics.py` (the reference's eval_toolbox/calc_metrics.py), flag for
flag:

    python -m dimsum_torch.calc_metrics --real-dir imagenet-256-png \\
        --gen-dir samples-50k --metrics fid50k_full,kid50k_full \\
        --detector inception:pt_inception-2015-12-05.pth

Folders or `.zip` archives of images (PNG read without PIL), center-cropped
to --image-size.  With several processes (--num-processes, --process-id,
--coordinator; one a card) both sides are sharded into contiguous slices,
the feature stats are combined over the process group and rank 0 reports.
The real side's stats are cached in --cache-dir.  Results are printed as
JSON lines and appended to `metric-<name>.jsonl` in --run-dir.  Runs on
the card unless --device cpu.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from dimsum_torch.parallel import init_distributed
from dimsum_torch.utils.device import rank_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--metrics", type=str, default="fid50k_full",
                   help="comma-separated registered metrics")
    p.add_argument("--real-dir", type=str, required=True)
    p.add_argument("--gen-dir", type=str, required=True)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--detector", type=str, default=None,
                   help="detector spec: None/randproj (smoke), "
                        "jax-random/inception-random (InceptionV3, seeded "
                        "weights), jax:<pth>/inception:<pth> (InceptionV3 "
                        "with a local torchvision state dict), <file.pt> "
                        "(TorchScript)")
    p.add_argument("--cache-dir", type=str, default="stats-cache")
    p.add_argument("--run-dir", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--mirror", action="store_true",
                   help="xflip-double the real dataset (the StyleGAN-ADA "
                        "convention of the *_full metrics)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--coordinator", type=str, default="localhost:29514")
    p.add_argument("--device", type=str, default="cuda",
                   help="the card unless 'cpu' is asked for")
    return p.parse_args(argv)


def evaluate_folders(metrics, real_dir: str, gen_dir: str, image_size: int,
                     detector_spec=None, batch_size: int = 64,
                     cache_dir=None, run_dir=None, mirror: bool = False,
                     device="cuda"):
    """The metrics of `gen_dir`'s images against `real_dir`'s, both
    sharded over the default process group (contiguous slices in rank
    order); every process calls it, rank 0 reports and returns the
    results, the others return []."""
    from dimsum_torch.data import ImageFolderDataset
    from dimsum_torch.eval import (calc_metrics_multiprocess, detector_id,
                                   make_detector, report_metric)
    from dimsum_torch.eval.dist_stats import world

    rank, size = world()
    detector = make_detector(detector_spec, device)
    real = ImageFolderDataset(real_dir, image_size, raw_uint8=True,
                              xflip=mirror)
    gen = ImageFolderDataset(gen_dir, image_size, raw_uint8=True)
    lo, hi = rank * len(gen) // size, (rank + 1) * len(gen) // size

    def gen_batches():
        for i in range(lo, hi, batch_size):
            yield np.stack([gen[j][0]
                            for j in range(i, min(i + batch_size, hi))])

    results = calc_metrics_multiprocess(
        metrics, real_dataset=real, detector=detector,
        gen_batches=gen_batches, batch_size=batch_size, cache_dir=cache_dir,
        dataset_id=real_dir, detector_id=detector_id(detector_spec),
        device=device)
    for result in results:
        report_metric(result, run_dir=run_dir)
    return results


def main(argv=None):
    """Run the CLI; returns rank 0's results ([] on the other ranks)."""
    from dimsum_torch.eval import is_valid_metric, list_valid_metrics

    args = parse_args(argv)
    for m in args.metrics.split(","):
        if not is_valid_metric(m.strip()):
            raise SystemExit(
                f"unknown metric {m!r}; valid: {list_valid_metrics()}")
    rank = init_distributed(args.coordinator, args.num_processes,
                            args.process_id, args.device)
    try:
        dev = rank_device(args.device, rank)
        if dev.type == "cuda":
            import torch

            torch.cuda.set_device(dev)
        results = evaluate_folders(
            args.metrics.split(","), args.real_dir, args.gen_dir,
            args.image_size, args.detector, args.batch_size,
            args.cache_dir, args.run_dir, args.mirror, dev)
        if args.num_processes > 1:
            dist.barrier()
        return results
    finally:
        if args.num_processes > 1 and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
