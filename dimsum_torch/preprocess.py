"""Encode an image folder into the latent memmap that
`python -m dimsum_torch.train --dataset latent_memmap` reads, the port of
the top-level `preprocess.py` (the reference's
preprocess_latent_imagenet_dat.py):

    python -m dimsum_torch.preprocess --datadir imagenet/train \\
        --outdir latents/ --image-size 256 --vae-ckpt sd-vae-ft-ema.bin \\
        --use-labels

Each of the N images gives two latents, its own and its horizontal
flip's, each a draw from the SD-VAE posterior times 0.18215
(`AutoencoderKL.encode`), written at rows i and N + i of `latents.dat`
((2N, 4, S/8, S/8) fp32) with its label at the same rows of `labels.dat`
((2N,) int64).  The draws come from one generator seeded --seed, drawn for
every batch in order.  The files are opened r+ when they exist, and a
batch whose rows are all written (non-zero) is skipped without changing
later draws, so a rerun resumes.  --shard-idx / --num-shards split the
images into contiguous shards for several processes.  Runs on the card
unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from dimsum_torch.data.datasets import ImageFolderDataset
from dimsum_torch.models.vae import load_vae
from dimsum_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--datadir", type=str, required=True,
                   help="image folder (class subfolders for labels)")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--vae-ckpt", type=str, required=True)
    p.add_argument("--use-labels", action="store_true")
    p.add_argument("--shard-idx", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="the card unless 'cpu' is asked for")
    return p.parse_args(argv)


def _memmap(path, dtype, shape):
    mode = "r+" if os.path.exists(path) else "w+"
    return np.memmap(path, dtype=dtype, mode=mode, shape=shape)


def _written(rows: np.ndarray) -> bool:
    return bool((np.abs(rows.reshape(len(rows), -1)).max(1) > 0).all())


def main(argv=None) -> dict:
    """Run the CLI; returns {"images": N, "encoded": batches encoded,
    "skipped": batches already written, "seconds": ...}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    dataset = ImageFolderDataset(args.datadir, args.image_size,
                                 use_labels=args.use_labels)
    n = len(dataset)
    latent = args.image_size // 8
    os.makedirs(args.outdir, exist_ok=True)
    feats = _memmap(os.path.join(args.outdir, "latents.dat"), np.float32,
                    (2 * n, 4, latent, latent))
    labels = _memmap(os.path.join(args.outdir, "labels.dat"), np.int64,
                     (2 * n,))
    vae = load_vae(args.vae_ckpt, dev)
    g = torch.Generator(dev).manual_seed(args.seed)
    per = n // args.num_shards
    start = args.shard_idx * per
    stop = n if args.shard_idx == args.num_shards - 1 else start + per
    record = {"images": stop - start, "encoded": 0, "skipped": 0}
    t0 = time.time()
    for i in range(start, stop, args.batch_size):
        j = min(i + args.batch_size, stop)
        noise = [torch.randn((j - i, 4, latent, latent), generator=g,
                             device=dev) for _ in range(2)]
        if _written(feats[i:j]) and _written(feats[n + i:n + j]):
            record["skipped"] += 1
            continue
        xs, ys = zip(*(dataset[k] for k in range(i, j)))
        x = torch.from_numpy(np.stack(xs)).to(dev)
        with torch.no_grad():
            z = vae.encode(x, noise=noise[0])
            z_flip = vae.encode(x.flip(-1), noise=noise[1])
        feats[i:j] = z.float().cpu().numpy()
        feats[n + i:n + j] = z_flip.float().cpu().numpy()
        labels[i:j] = ys
        labels[n + i:n + j] = ys
        feats.flush()
        labels.flush()
        record["encoded"] += 1
        print(f"{j - start}/{stop - start} images "
              f"({(j - start) / (time.time() - t0):.1f} img/s)",
              file=sys.stderr)
    record["seconds"] = time.time() - t0
    print(f"wrote latents for {stop - start} images (x2 with flips) to "
          f"{args.outdir}")
    return record


if __name__ == "__main__":
    main()
