"""Dump a training dataset to a folder of images, the real side of FID,
the port of `tools/extract_real_samples.py` (the reference's
eval_toolbox/resize_lmdb.py): each image with the training transform
(center crop to --image_size) as `<save_dir>/<dataset>/<index>.png`:

    python -m dimsum_torch.tools.extract_real_samples --dataset celeba_256 \\
        --datadir data/celeba --save_dir real_samples --image_size 256

Any pixel dataset `dimsum_torch.data.get_dataset` serves (image folders,
LMDBs); latent datasets are refused.  The files are PNGs (`utils/png.py`),
not the JAX tool's JPEGs: lossless, and read back without PIL.  The
dataset's [-1, 1] floats are rounded back to their 8-bit values, where the
JAX tool's truncation takes 1 off some of them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> str:
    """Run the tool; returns the folder written."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--datadir", default="./data")
    p.add_argument("--save_dir", default="real_samples/")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--max_images", type=int, default=None,
                   help="a cap (the reference caps lsun_church at 120k)")
    args = p.parse_args(argv)
    if "latent" in args.dataset:
        raise SystemExit("latent datasets hold VAE codes, not images")

    from dimsum_torch.data import get_dataset
    from dimsum_torch.utils.png import write_png

    dataset = get_dataset(argparse.Namespace(
        dataset=args.dataset, datadir=args.datadir,
        image_size=args.image_size))
    n = len(dataset)
    if args.dataset == "lsun_church":
        n = min(n, 120_000)  # the reference's resize_lmdb.py:39 subset
    if args.max_images:
        n = min(n, args.max_images)
    save_dir = os.path.join(args.save_dir, args.dataset)
    os.makedirs(save_dir, exist_ok=True)
    for i in range(n):
        x, _ = dataset[i]  # CHW in [-1, 1], v / 127.5 - 1 of 8-bit v
        img = np.clip(np.rint((np.asarray(x) + 1) * 127.5), 0, 255)
        write_png(os.path.join(save_dir, f"{i}.png"),
                  img.astype(np.uint8).transpose(1, 2, 0))
        if (i + 1) % 1000 == 0:
            print(f"{i + 1}/{n}")
    print(f"saved {n} images in {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
