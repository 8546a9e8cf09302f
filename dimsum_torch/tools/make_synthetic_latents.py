"""A class-conditional latent memmap (and, optionally, decoded "real"
images) for running the train and FID pipelines end to end without
ImageNet or SD-VAE weights, the port of `tools/make_synthetic_latents.py`:

    python -m dimsum_torch.tools.make_synthetic_latents --out synth \\
        --n 4096 --classes 8 --image-size 256 [--decode-real random \\
        --n-real 512]

Latents: a smooth random pattern a class, plus low-frequency jitter and
noise a sample, at the SD latent scale, in the layout
`dimsum_torch.preprocess` writes (latents.dat (N, C, H, W) fp32,
labels.dat (N,) int64), the JAX tool's draws from the same seed.  With
--decode-real (a VAE path or random[:seed]) the first --n-real latents
are decoded by the port's VAE into PNGs under <out>/real_png (--n-real of
them; the JAX tool writes whole batches of 16).  Runs the decode on the
card unless --device cpu.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def smooth_noise(rng, shape, up):
    """Low-frequency noise: a small grid repeated up, then box-blurred
    along each axis."""
    c, h, w = shape
    small = rng.standard_normal((c, max(h // up, 1), max(w // up, 1)))
    big = small.repeat(up, axis=1).repeat(up, axis=2)[:, :h, :w]
    k = np.ones(up, np.float32) / up
    for ax in (1, 2):
        big = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, big)
    return big


def main(argv=None) -> str:
    """Run the tool; returns the output folder."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-real", type=str, default=None,
                    help="VAE path or random[:seed]: decode the first "
                         "--n-real latents into PNGs under <out>/real_png")
    ap.add_argument("--n-real", type=int, default=512)
    ap.add_argument("--device", type=str, default="cuda",
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    latent = args.image_size // 8
    shape = (args.channels, latent, latent)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    patterns = np.stack([smooth_noise(rng, shape, up=8)
                         for _ in range(args.classes)]).astype(np.float32)
    patterns *= 1.2 / (np.abs(patterns).mean() + 1e-8) * 0.5
    feats = np.memmap(os.path.join(args.out, "latents.dat"), np.float32,
                      mode="w+", shape=(args.n, *shape))
    labels = np.memmap(os.path.join(args.out, "labels.dat"), np.int64,
                       mode="w+", shape=(args.n,))
    for i in range(args.n):
        y = int(rng.integers(args.classes))
        jit = smooth_noise(rng, shape, up=4).astype(np.float32) * 0.45
        eps = rng.standard_normal(shape).astype(np.float32) * 0.25
        feats[i] = patterns[y] + jit + eps
        labels[i] = y
    feats.flush()
    labels.flush()
    print(f"wrote {args.n} latents {shape} + labels to {args.out}")

    if args.decode_real:
        import torch

        from dimsum_torch.eval.features import latents_to_uint8
        from dimsum_torch.models.vae import load_vae
        from dimsum_torch.utils.png import write_png

        vae = load_vae(args.decode_real, args.device)
        outdir = os.path.join(args.out, "real_png")
        os.makedirs(outdir, exist_ok=True)
        n, bs = min(args.n_real, args.n), 16
        for i in range(0, n, bs):
            z = torch.from_numpy(np.asarray(feats[i:min(i + bs, n)])).to(
                vae.quant_conv.weight.device)
            with torch.no_grad():
                imgs = latents_to_uint8(vae.decode(z)).cpu().numpy()
            for j, im in enumerate(imgs):
                write_png(os.path.join(outdir, f"{i + j:06d}.png"),
                          im.transpose(1, 2, 0))
        print(f"decoded {n} reference images to {outdir}")
    return args.out


if __name__ == "__main__":
    main()
