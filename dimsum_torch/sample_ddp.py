"""Generate samples for FID-50K and score them, the port of the top-level
`sample_ddp.py` (the reference's sample_ddp.py), flag for flag:

    python -m dimsum_torch.sample_ddp ODE --model DiM-L/2 --image-size 256 \\
        --ckpt dimsum-L2-imagenet256.pt --path-type GVP --num-classes 1001 \\
        --block-type combined --bimamba-type none --rms-norm --cond-mamba \\
        --learnable-pe --use-attn-every-k-layers 4 --bf16 --cfg-scale 1.4 \\
        --vae-ckpt sd-vae-ft-ema.bin --num-fid-samples 50000 \\
        --eval-refdir imagenet-256-png --eval-detector inception:pt_inception.pth \\
        --eval-metric fid50k_full,kid50k_full,pr50k3_full --eval-streaming

Each process generates its contiguous slice of --num-fid-samples in
batches of --per-proc-batch-size from the generator seeded
global_seed * num_processes + rank (the reference's per-rank seed), with
the model, CFG and transport of `dimsum_torch.sample`.  Three routes:

  * no --vae-ckpt: the latents go to `latents.npz` (`latents_rank<r>.npz`
    with several processes);
  * --eval-streaming with --eval-refdir: each batch is decoded, quantized
    to uint8 and run through the detector on the card, and its features go
    to `feat-chunks-rank<r>/chunk<i>.npy`; a rerun regenerates no batch
    whose chunk is on disk.  --save-images also writes the PNGs.  The
    features of every rank are combined and rank 0 reports the metrics;
  * otherwise: PNGs into --sample-dir, then, with --eval-refdir, the
    metrics over the folder (as `dimsum_torch.calc_metrics`).

Metrics go to `metric-<name>.jsonl` in --sample-dir; the real side's
feature stats are cached in `<sample-dir>/../stats-cache`.  Several
processes: --num-processes, --process-id and --coordinator (host:port of
rank 0), one process a card (NCCL; gloo on the CPU and for ranks that
share a card).  Runs on the card unless --device cpu.

--tp k (the JAX CLI's, sample_ddp.py:122-135): the processes form a (data,
model) mesh of num-processes / k data rows (`parallel.make_mesh_groups`),
each row one tensor-parallel model (`DiMConfig.tp_group`; with --is-moe,
expert parallelism); the rows split the samples as the processes do
without --tp (the global batch is the per-process batch times the data
ways), a row's ranks draw the row's noise and compute the same samples,
and only the row's first rank writes them (latents, PNGs, feature chunks);
the other ranks take part in the metrics with no samples of their own.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from dimsum_torch.cli import (add_model_args, add_moe_args,
                              add_ode_args, add_sde_args, add_transport_args,
                              add_vae_args, build_transport, model_config)
from dimsum_torch.models.vae import load_vae
from dimsum_torch.parallel import init_distributed, make_mesh_groups
from dimsum_torch.sample import load_model, model_fn_for, with_null_class
from dimsum_torch.transport import Sampler
from dimsum_torch.utils.device import rank_device
from dimsum_torch.utils.png import write_png


def parse_args(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = "ODE"
    if argv and argv[0] in ("ODE", "SDE"):
        mode = argv.pop(0)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_moe_args(p)
    add_transport_args(p)
    add_vae_args(p)
    if mode == "ODE":
        add_ode_args(p)
    else:
        add_sde_args(p)
    p.add_argument("--ckpt", type=str, default=None,
                   help="a reference .pt checkpoint")
    p.add_argument("--params", type=str, default="ema",
                   choices=["ema", "raw"])
    p.add_argument("--per-proc-batch-size", type=int, default=64)
    p.add_argument("--num-fid-samples", type=int, default=50_000)
    p.add_argument("--num-sampling-steps", type=int, default=250)
    p.add_argument("--cfg-scale", type=float, default=1.0)
    p.add_argument("--global-seed", type=int, default=0)
    p.add_argument("--sample-dir", type=str, default="samples-50k")
    p.add_argument("--image-ext", type=str, default="png", choices=["png"],
                   help="the images are PNG files (utils/png.py)")
    p.add_argument("--use-even-classes", action="store_true")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways: the processes form a "
                        "(num-processes / tp, tp) mesh")
    p.add_argument("--eval-refdir", type=str, default=None,
                   help="folder (or .zip) of real images")
    p.add_argument("--eval-metric", type=str, default="fid50k_full",
                   help="comma-separated registered metrics")
    p.add_argument("--eval-streaming", action="store_true",
                   help="features straight from the decoded batches on the "
                        "card, resumable by feature chunks, instead of the "
                        "PNG round trip")
    p.add_argument("--save-images", action="store_true",
                   help="with --eval-streaming: also write the PNGs")
    p.add_argument("--eval-detector", type=str, default=None,
                   help="detector spec: None/randproj (smoke), "
                        "jax-random/inception-random (InceptionV3, seeded "
                        "weights), jax:<pth>/inception:<pth> (InceptionV3 "
                        "with a local torchvision state dict), <file.pt> "
                        "(TorchScript)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--coordinator", type=str, default="localhost:29513")
    p.add_argument("--device", type=str, default="cuda",
                   help="the card unless 'cpu' is asked for")
    args = p.parse_args(argv)
    args.mode = mode
    return args


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(world: int):
    if world > 1:
        dist.barrier()


class Generator:
    """This process's slice of the samples, batch by batch: batch `it`'s
    noise, labels and SDE seed come from one generator drawn in batch
    order whether or not the batch is generated, so that a rerun that
    skips batches gives the others unchanged."""

    def __init__(self, args, rank: int, world: int, dev, tp_group=None):
        self.args, self.dev = args, dev
        if args.label_dropout < 0:
            args.label_dropout = 0.1 if args.num_classes > 1 else 0.0
        self.cfg = cfg = dataclasses.replace(model_config(args),
                                             tp_group=tp_group)
        self.net = load_model(args, cfg, dev)
        self.model_fn = model_fn_for(args, self.net, cfg)
        sampler = Sampler(build_transport(args))
        if args.mode == "ODE":
            self.sample = sampler.sample_ode(
                sampling_method=args.sampling_method,
                num_steps=args.num_sampling_steps, atol=args.atol,
                rtol=args.rtol)
        else:
            self.sample = sampler.sample_sde(
                sampling_method=args.sampling_method,
                diffusion_form=args.diffusion_form,
                diffusion_norm=args.diffusion_norm,
                last_step=args.last_step,
                last_step_size=args.last_step_size,
                num_steps=args.num_sampling_steps)
        self.use_cfg = args.cfg_scale > 1.0 and args.num_classes > 1
        self.num_real = args.num_classes - (1 if args.num_classes > 1 else 0)
        self.batch = args.per_proc_batch_size
        per_proc = -(-args.num_fid_samples // world)
        self.offset = rank * per_proc
        self.samples = max(0, min(per_proc,
                                  args.num_fid_samples - self.offset))
        self.iters = -(-self.samples // self.batch)
        self.generator = torch.Generator(dev).manual_seed(
            args.global_seed * world + rank)
        self.seconds = 0.0
        self.generated = 0  # batches generated (not skipped) in this run

    def batches(self, skip=lambda it: False):
        """(it, latents of the batch's samples) for every batch `it` with
        skip(it) false; the latents are cut to the slice's end."""
        args, dev, g, n = self.args, self.dev, self.generator, self.batch
        shape = (n, self.cfg.in_channels, self.cfg.img_resolution,
                 self.cfg.img_resolution)
        for it in range(self.iters):
            z = torch.randn(shape, generator=g, device=dev)
            y = torch.randint(0, max(self.num_real, 1), (n,), generator=g,
                              device=dev)
            sde_seed = int(torch.randint(2 ** 62, (1,), generator=g,
                                         device=dev).item())
            if skip(it):
                continue
            if args.use_even_classes and self.num_real > 0:
                y = (torch.arange(n, device=dev) + self.offset
                     + it * n) % self.num_real
            if self.use_cfg:
                z, y = with_null_class(z, y, self.num_real)
            _sync(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                if args.mode == "ODE":
                    out = self.sample(z, self.model_fn, y=y)
                else:
                    out = self.sample(z, self.model_fn, y=y,
                                      generator=torch.Generator(
                                          dev).manual_seed(sde_seed))
            _sync(dev)
            self.seconds += time.perf_counter() - t0
            self.generated += 1
            out = out[:n] if self.use_cfg else out
            yield it, out[: self.samples - it * n]


def main(argv=None) -> dict:
    """Run the CLI; returns a record of this process's run: its samples,
    the batches it generated, the seconds of each stage and the metric
    results (rank 0)."""
    args = parse_args(argv)
    rank = init_distributed(args.coordinator, args.num_processes,
                            args.process_id, args.device)
    world = max(args.num_processes, 1)
    if world % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide {world} processes")
    try:
        return _run(args, rank, world, rank_device(args.device, rank))
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, rank: int, world: int, dev) -> dict:
    t_start = time.perf_counter()
    if dev.type == "cuda":
        from dimsum_torch.ops import cuda_build

        torch.cuda.set_device(dev)
        cuda_build.build()
    mesh = make_mesh_groups(world // args.tp, args.tp) if args.tp > 1 \
        else None
    # the data row (the samples' slice) and whether this rank writes them
    row, rows = (mesh.data_index, mesh.data_ways) if mesh else (rank, world)
    writer = mesh is None or mesh.model_index == 0
    wrank = row * args.tp  # the rank that writes the row's files
    gen = Generator(args, row, rows, dev, mesh.model if mesh else None)
    vae = load_vae(args.vae_ckpt, dev) if args.vae_ckpt else None
    os.makedirs(args.sample_dir, exist_ok=True)
    seconds = {"decode": 0.0, "features": 0.0, "write": 0.0, "metrics": 0.0}
    record = {"rank": rank, "world": world, "samples": gen.samples,
              "batches": gen.iters, "seconds": seconds, "results": [],
              "data_ways": rows, "writer": writer}

    def finish():
        _barrier(world)
        seconds["generate"] = gen.seconds
        seconds["total"] = time.perf_counter() - t_start
        record["generated_batches"] = gen.generated
        print(f"[rank {rank}] seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in seconds.items()), file=sys.stderr)
        return record

    if vae is None:
        lat = [out.float().cpu().numpy() for _, out in gen.batches()]
        lat = (np.concatenate(lat) if lat else
               np.zeros((0, gen.cfg.in_channels, gen.cfg.img_resolution,
                         gen.cfg.img_resolution), np.float32))
        record["latents"] = lat
        if not writer:
            return finish()
        suffix = f"_rank{row}" if rows > 1 else ""
        path = os.path.join(args.sample_dir, f"latents{suffix}.npz")
        np.savez(path, latents=lat)
        record["latents_path"] = path
        print(f"wrote latents for {len(lat)} samples to {path} (no "
              "--vae-ckpt: metrics over pixels unavailable)",
              file=sys.stderr)
        return finish()

    def decoded(skip=lambda it: False):
        """(it, uint8 NCHW images on the device), the PNGs written when
        asked for."""
        from dimsum_torch.eval.features import latents_to_uint8

        save = (not args.eval_streaming or args.save_images) and writer
        for it, out in gen.batches(skip):
            t0 = time.perf_counter()
            with torch.no_grad():
                imgs = latents_to_uint8(vae.decode(out))
            _sync(dev)
            seconds["decode"] += time.perf_counter() - t0
            if save:
                t0 = time.perf_counter()
                first = gen.offset + it * gen.batch
                for i, im in enumerate(imgs.permute(0, 2, 3, 1).cpu()
                                       .numpy()):
                    write_png(os.path.join(args.sample_dir,
                                           f"{first + i:06d}.png"), im)
                seconds["write"] += time.perf_counter() - t0
            yield it, imgs

    metrics = args.eval_metric.split(",")
    image_size = gen.cfg.img_resolution * 8
    if args.eval_streaming and args.eval_refdir:
        from dimsum_torch.eval import make_detector

        detector = make_detector(args.eval_detector, dev)
        # numpy detectors (randproj) run on the host
        record["detector_device"] = str(getattr(detector, "device", "cpu"))
        record["results"] = _streaming(args, wrank, gen, decoded, detector,
                                       metrics, image_size, seconds, writer)
        return finish()

    for _ in decoded():
        pass
    _barrier(world)
    if args.eval_refdir:
        from dimsum_torch.calc_metrics import evaluate_folders

        t0 = time.perf_counter()
        record["results"] = evaluate_folders(
            metrics, args.eval_refdir, args.sample_dir, image_size,
            args.eval_detector, cache_dir=_cache_dir(args),
            run_dir=args.sample_dir, device=dev)
        seconds["metrics"] += time.perf_counter() - t0
    return finish()


def _cache_dir(args) -> str:
    return os.path.join(args.sample_dir, "..", "stats-cache")


def _streaming(args, rank, gen, decoded, detector, metrics, image_size,
               seconds, writer: bool = True):
    """The streaming route: features of each decoded batch into rank
    `rank`'s chunk files (batches whose chunk is on disk are not
    generated), then the metrics over the combined features; a rank that
    is not its row's `writer` generates the same batches and adds no
    samples of its own."""
    from dimsum_torch.data import ImageFolderDataset
    from dimsum_torch.eval import (FeatureStats, calc_metrics_multiprocess,
                                   detector_id, report_metric)

    feat_dir = os.path.join(args.sample_dir, f"feat-chunks-rank{rank}")
    os.makedirs(feat_dir, exist_ok=True)

    def chunk(it):
        return os.path.join(feat_dir, f"chunk{it:06d}.npy")

    # fixed before the first batch, so that a row's ranks skip alike
    on_disk = {it for it in range(gen.iters) if os.path.exists(chunk(it))}
    if on_disk:
        print(f"[rank {rank}] resuming: {len(on_disk)}/{gen.iters} feature "
              "chunks on disk", file=sys.stderr)
    for it, imgs in decoded(skip=lambda it: it in on_disk):
        if not writer:
            continue
        t0 = time.perf_counter()
        feats = detector(imgs)
        seconds["features"] += time.perf_counter() - t0
        tmp = os.path.join(feat_dir, f".chunk{it:06d}.tmp.npy")
        np.save(tmp, feats)
        os.replace(tmp, chunk(it))

    t0 = time.perf_counter()
    need_all = any(not m.strip().startswith("fid") for m in metrics)
    gen_stats = FeatureStats(capture_all=need_all, capture_mean_cov=True,
                             max_items=gen.samples)
    for it in range(gen.iters if writer else 0):
        gen_stats.append(np.load(chunk(it)))
    real = ImageFolderDataset(args.eval_refdir, image_size, raw_uint8=True)
    results = calc_metrics_multiprocess(
        metrics, real_dataset=real, detector=detector, gen_stats=gen_stats,
        cache_dir=_cache_dir(args),
        dataset_id=args.eval_refdir,
        detector_id=detector_id(args.eval_detector), device=gen.dev)
    for result in results:
        report_metric(result, run_dir=args.sample_dir)
    seconds["metrics"] += time.perf_counter() - t0
    return results


if __name__ == "__main__":
    main()
