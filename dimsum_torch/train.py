"""Training CLI of the port, `python -m dimsum_torch.train`: the JAX
package's `train.py` (the reference's train.py) on PyTorch/CUDA, with its
flags on the argument groups of `dimsum_torch/cli.py`, its defaults and
its loop.  DiM-L/2 on an ImageNet latent memmap (the layout
`preprocess.py` writes), as the reference's recipe (scripts/train.sh):

    python -m dimsum_torch.train --exp run --dataset latent_memmap_imagenet \\
        --datadir latents/ --model DiM-L/2 --block-type combined \\
        --bimamba-type none --rms-norm --cond-mamba --learnable-pe \\
        --use-attn-every-k-layers 4 --num-classes 1000 --drop-path 0.1 \\
        --path-type GVP --bf16 --global-batch-size 16 --vae-ckpt random

Each epoch: the loader's shuffled batches (`data.Loader`, copied to the
card from pinned memory one batch ahead), one train step each
(`parallel.make_train_step`: flow-matching loss, AdamW, clip, EMA; with
--grad-accum micro-batches), the window-mean loss logged every
--log-every steps with one host read a window; then the content
checkpoint every --save-content-every epochs (keep 2), a numbered snapshot
every --ckpt-every epochs (keep 10) and, with --vae-ckpt, a grid of EMA
samples (50 Euler steps, VAE decode, PNG) every --plot-every epochs, all
under --results-dir/--exp.  --resume continues from the latest content
checkpoint at step // steps-per-epoch; --model-ckpt warm-starts from a
reference `.pt` ("model" weights, adapted across resolutions).
--grad-checkpoint / --remat-policy recompute the blocks in the backward.

Data parallelism is one process a card (the reference's DDP): run one
process a rank with --num-processes, --process-id and --coordinator
(host:port of rank 0); each loads its stripe of the epoch, steps
global-batch / num-processes samples with its own generator (seeded
global_seed * num_processes + rank), and the gradients and the loss are
averaged over the ranks before the update.  The backend is NCCL on the
card and gloo on the CPU or where ranks share a card
(`parallel.init_distributed`).

A pixel dataset (an image folder, an LMDB) needs --vae-ckpt: each batch
is encoded on the card (a draw from the posterior, from the process's
generator) before its step.  With --eval-refdir (a folder of real
images) and --vae-ckpt, every --eval-every epochs rank 0 scores
`fid2k_full` on --eval-nsamples images (batches of --eval-bs) generated
from the EMA weights (50 Euler steps) and decoded, through the detector
of --eval-detector, made once for the run; the result goes to
`metric-fid2k_full.jsonl` and the real side's stats to `stats-cache/` in
the run's directory.

Tensor parallelism (--tp k, the JAX CLI's, train.py:144-160): the
processes form a (data, model) mesh of num-processes / k data rows of k
ranks (`parallel.make_mesh_groups`); a row's ranks hold the shards of the
sharded parameters (`parallel/mesh.py::TP_RULES`; with --is-moe the experts
split over them, expert parallelism with capacity dispatch at
`moe_capacity_factor`), take the row's batch and draws (seeded
global_seed * data_ways + row) and step the unsharded model's update; the
gradients are averaged over the data ways only.  Saves, resume and the
EMA go through the gathered, unsharded state (`utils/ckpt.py`), so a
--tp run's checkpoint loads at --tp 1 and into JAX.  The log line is the
JAX CLI's.

On the CPU: --device cpu.  The kernels are built (nvcc, in parallel)
before the first step.  --no-lr-decay, --min-lr and --warmup-epochs
are the reference's dead flags, as in the JAX CLI: the lr is constant
(`parallel.warmup_cosine_schedule` exists, off).  A resumed run starts its
generators from their seeds again, as the reference's and the JAX CLI's
do.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from dimsum_torch.cli import (add_model_args, add_moe_args,
                              add_transport_args, add_vae_args,
                              build_transport, model_config)
from dimsum_torch.data import Loader, device_batches, get_dataset
from dimsum_torch.models.factory import build_model
from dimsum_torch.models.vae import load_vae
from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                   init_distributed, make_mesh_groups,
                                   make_train_step)
from dimsum_torch.transport import Sampler
from dimsum_torch.utils.ckpt import (load_torch_checkpoint,
                                     restore_checkpoint, save_checkpoint,
                                     unsharded_meta)
from dimsum_torch.utils.device import rank_device
from dimsum_torch.utils.png import write_png

PLOT_STEPS = 50  # Euler steps of the sample grids (the JAX `_eval_gen_fn`)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_moe_args(p)
    add_transport_args(p)
    add_vae_args(p)
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--results-dir", type=str, default="results")
    p.add_argument("--epochs", type=int, default=1400)
    p.add_argument("--global-batch-size", type=int, default=256)
    p.add_argument("--global-seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=25,
                   help="epochs between numbered snapshots")
    p.add_argument("--save-content-every", type=int, default=5)
    p.add_argument("--plot-every", type=int, default=5)
    p.add_argument("--model-ckpt", type=str, default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-processes", type=int, default=1,
                   help="processes of a data-parallel run, one a card")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in [0, --num-processes)")
    p.add_argument("--coordinator", type=str, default="localhost:29512",
                   help="host:port of rank 0's rendezvous")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways: the processes form a "
                        "(num-processes / tp, tp) mesh")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches folded into one optimizer update")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-grad-norm", type=float, default=2.0)
    p.add_argument("--ema-decay", type=float, default=0.9999,
                   help="EMA decay per optimizer step (the reference "
                        "hard-codes 0.9999)")
    p.add_argument("--no-lr-decay", action="store_true", default=False,
                   help="(the reference's no-op: the lr is constant)")
    p.add_argument("--min-lr", type=float, default=1e-6,
                   help="(the reference's no-op, see --no-lr-decay)")
    p.add_argument("--warmup-epochs", type=int, default=5,
                   help="(the reference's no-op, see --no-lr-decay)")
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--eval-refdir", type=str, default=None,
                   help="folder of real images: in-training fid2k_full "
                        "every --eval-every epochs (needs --vae-ckpt)")
    p.add_argument("--eval-nsamples", type=int, default=1000)
    p.add_argument("--eval-bs", type=int, default=4)
    p.add_argument("--eval-cfg-scale", type=float, default=1.0)
    p.add_argument("--eval-detector", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the card unless 'cpu' is asked for")
    return p.parse_args(argv)


class Trainer:
    """One training run: `Trainer(args)` sets up (process group, model,
    optimizer, data, VAE, resume), `fit()` runs the epochs, `close()`
    releases the log file and the process group.  `history` holds one
    record a log window; `train_steps` and `init_epoch` say where the run
    stands."""

    def __init__(self, args):
        self.args = args
        self.rank = init_distributed(args.coordinator, args.num_processes,
                                     args.process_id, args.device)
        self.world = max(args.num_processes, 1)
        if self.world % args.tp:
            raise ValueError(f"--tp {args.tp} does not divide "
                             f"{self.world} processes")
        self.mesh = (make_mesh_groups(self.world // args.tp, args.tp)
                     if args.tp > 1 else None)
        # the data row of this process and the rows' count
        self.row, self.rows = ((self.mesh.data_index, self.mesh.data_ways)
                               if self.mesh else (self.rank, self.world))
        self.tp_group = self.mesh.model if self.mesh else None
        self.device = dev = rank_device(args.device, self.rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        self.exp_dir = os.path.join(args.results_dir, args.exp)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.logger = self._make_logger()
        self.log = self.logger.info
        self.log(f"args: {vars(args)}")

        if args.label_dropout < 0:
            args.label_dropout = 0.1 if args.num_classes > 1 else 0.0
        self.use_labels = args.num_classes > 1
        self.pixels = "latent" not in args.dataset
        if self.pixels and not args.vae_ckpt:
            raise SystemExit(
                f"--dataset {args.dataset} is in pixels and needs --vae-ckpt "
                "(local diffusers VAE weights); or encode it first with "
                "python -m dimsum_torch.preprocess")
        if args.eval_refdir and not args.vae_ckpt:
            raise SystemExit("--eval-refdir needs --vae-ckpt to decode the "
                             "samples")
        self.dataset = get_dataset(args)
        if args.global_batch_size % self.rows:
            raise ValueError(f"--global-batch-size {args.global_batch_size}"
                             f" does not split over {self.rows} data rows")
        batch = args.global_batch_size // self.rows
        if batch % args.grad_accum:
            raise ValueError(f"per-process batch {batch} not divisible by "
                             f"--grad-accum {args.grad_accum}")
        self.loader = Loader(self.dataset, batch, shuffle=True,
                             seed=args.global_seed,
                             num_workers=args.num_workers,
                             shard_id=self.row, num_shards=self.rows)
        self.log(f"dataset: {len(self.dataset)} samples, {len(self.loader)} "
                 f"steps/epoch, {self.world} process(es), {dev}")
        if self.mesh:
            self.log(f"tensor-parallel: params sharded over model={args.tp}"
                     f" ({self.rows} data row(s))")

        if dev.type == "cuda":
            from dimsum_torch.ops import cuda_build

            cuda_build.build()
        self.cfg = dataclasses.replace(model_config(args),
                                       tp_group=self.tp_group)
        model = build_model(self.cfg, dev, seed=args.global_seed, train=True)
        if args.scan_impl == "ref":
            for m in model.modules():
                if hasattr(m, "scan_impl"):
                    m.scan_impl = "ref"
        if args.model_ckpt:
            if self.tp_group is not None:
                raise NotImplementedError(
                    "--model-ckpt with --tp: warm-start at --tp 1, save, and "
                    "resume the snapshot at --tp")
            load_torch_checkpoint(args.model_ckpt, model, key="model",
                                  adapt=True)
            self.log(f"warm-started from {args.model_ckpt}")
        self.transport = build_transport(args)
        optimizer = create_optimizer(model, lr=args.lr, weight_decay=0.0)
        self.state = create_train_state(model, optimizer)
        n_params = sum(p.numel() for p in model.parameters())
        if self.mesh:  # the whole model's, as JAX counts it
            n_params = sum(p.numel() for p in
                           unsharded_meta(model).parameters())
        self.log(f"model params: {n_params / 1e6:.1f}M")
        self.vae = load_vae(args.vae_ckpt, dev) if args.vae_ckpt else None

        self.train_steps = self.init_epoch = 0
        self.content_dir = os.path.join(self.exp_dir, "content")
        if args.resume:
            restored, step = restore_checkpoint(self.content_dir, self.state,
                                                tp_group=self.tp_group)
            if restored is not None:
                self.train_steps = step
                self.init_epoch = step // max(len(self.loader), 1)
                self.log(f"resumed at step {step} (epoch {self.init_epoch})")
        self.train_step = make_train_step(
            model, self.transport, optimizer,
            max_grad_norm=args.max_grad_norm, ema_decay=args.ema_decay,
            use_labels=self.use_labels, grad_accum=args.grad_accum,
            group=(self.mesh.data if self.mesh else dist.group.WORLD)
            if self.rows > 1 else None, tp_group=self.tp_group)
        self.generator = torch.Generator(dev).manual_seed(
            args.global_seed * self.rows + self.row)
        self.history = []
        self.detector = None  # in-training FID's, made at its first use

    def _make_logger(self) -> logging.Logger:
        """Rank 0 logs to stderr and `log.txt` in the run's directory; the
        other ranks log warnings to stderr (the reference's create_logger,
        train.py:82-97)."""
        logger = logging.getLogger(f"dimsum_torch.train.{id(self)}")
        logger.propagate = False
        logger.setLevel(logging.INFO if self.rank == 0 else logging.WARNING)
        fmt = logging.Formatter("[%(asctime)s] %(message)s")
        handlers = [logging.StreamHandler(sys.stderr)]
        if self.rank == 0:
            handlers.append(logging.FileHandler(
                os.path.join(self.exp_dir, "log.txt")))
        for h in handlers:
            h.setFormatter(fmt)
            logger.addHandler(h)
        return logger

    def fit(self):
        args, state = self.args, self.state
        window, log_steps, start = [], 0, time.perf_counter()
        for epoch in range(self.init_epoch, args.epochs + 1):
            self.loader.set_epoch(epoch)
            self.log(f"beginning epoch {epoch}")
            for x, y in device_batches(self.loader, self.device):
                if self.pixels:
                    with torch.no_grad():
                        x = self.vae.encode(x, self.generator)
                metrics = self.train_step(state, x, y, self.generator)
                window.append(metrics["loss"])  # on the device: no sync
                self.train_steps += 1
                log_steps += 1
                if self.train_steps % args.log_every == 0:
                    loss, grad_norm = torch.stack([
                        torch.stack(window).float().mean(),
                        metrics["grad_norm"].float()]).tolist()
                    seconds = time.perf_counter() - start
                    self.history.append(dict(
                        step=self.train_steps, loss=loss,
                        grad_norm=grad_norm, steps=log_steps,
                        seconds=seconds))
                    self.log(f"(step={self.train_steps:07d}) loss={loss:.4f}"
                             f" grad_norm={grad_norm:.3f} "
                             f"steps/sec={log_steps / seconds:.2f}")
                    window, log_steps = [], 0
                    start = time.perf_counter()
            paused = time.perf_counter()
            if epoch % args.save_content_every == 0:
                save_checkpoint(self.content_dir, state,
                                step=self.train_steps, keep=2, args=args,
                                tp_group=self.tp_group)
                self.log(f"saved content checkpoint at step "
                         f"{self.train_steps}")
            if epoch % args.ckpt_every == 0 and epoch > 0:
                save_checkpoint(os.path.join(self.exp_dir, "checkpoints"),
                                state, step=self.train_steps, keep=10,
                                args=args, tp_group=self.tp_group)
                self.log(f"saved snapshot at step {self.train_steps}")
            # rank 0's work; its model group samples beside it
            if (epoch % args.plot_every == 0 and self.vae is not None
                    and self.row == 0):
                self.plot_samples(epoch)
            if (args.eval_refdir and self.row == 0
                    and epoch % args.eval_every == 0 and epoch > 0):
                self.evaluate()
            # the steps/sec of a window leave out the saves and the plots
            start += time.perf_counter() - paused
        self.log("done")

    @torch.no_grad()
    def plot_samples(self, epoch: int) -> str:
        """A grid of EMA samples (the JAX `_plot_samples`): min(eval_bs * 4,
        16) latents drawn from seed `epoch`, 50 Euler steps of the
        sampler in chunks that shrink with the resolution, the VAE decode,
        one PNG.  Returns its path."""
        args, cfg, dev = self.args, self.cfg, self.device
        n = min(args.eval_bs * 4, 16)
        chunk = max(1, n // max(1, (args.image_size // 256) ** 2))
        n = (n // chunk) * chunk
        g = torch.Generator(dev).manual_seed(epoch)
        imgs = torch.cat([self.ema_images(chunk, g)
                          for _ in range(0, n, chunk)])
        if self.rank != 0:  # a model rank beside rank 0
            return None
        imgs = ((imgs + 1) / 2 * 255).clamp(0, 255).to(torch.uint8).cpu()
        side = int(np.ceil(np.sqrt(n)))
        H, W = imgs.shape[2], imgs.shape[3]
        grid = np.zeros((side * H, side * W, 3), np.uint8)
        for i, im in enumerate(imgs.numpy()):
            r, c = divmod(i, side)
            grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = im.transpose(1, 2, 0)
        path = os.path.join(self.exp_dir, f"samples_epoch{epoch:05d}.png")
        write_png(path, grid)
        self.log(f"wrote {path}")
        return path

    @torch.no_grad()
    def ema_images(self, n: int, generator) -> torch.Tensor:
        """n images in [-1, 1] (float, NCHW) from the EMA weights: noise
        and labels drawn from `generator`, 50 Euler steps of the sampler
        (the JAX `_eval_gen_fn`), the VAE decode."""
        cfg, dev = self.cfg, self.device
        z = torch.randn((n, cfg.in_channels, cfg.img_resolution,
                         cfg.img_resolution), generator=generator,
                        device=dev)
        y = torch.randint(0, max(self.args.num_classes, 1), (n,),
                          generator=generator, device=dev)
        sample = Sampler(self.transport).sample_ode(
            sampling_method="euler", num_steps=PLOT_STEPS)
        model, ema = self.state.model, self.state.ema_params

        def model_fn(x, t, **kw):
            return functional_call(model, ema, (x, t), kw)

        return self.vae.decode(sample(z, model_fn, y=y)).float()

    def evaluate(self) -> dict:
        """In-training FID (the JAX `_in_training_fid`, the reference's
        train.py:393-482): `fid2k_full` of --eval-nsamples EMA images (in
        batches of --eval-bs, from generator seed 0) against --eval-refdir,
        through the run's detector; reported to `metric-fid2k_full.jsonl`
        in the run's directory, the real side's stats cached under it."""
        from dimsum_torch.data import ImageFolderDataset
        from dimsum_torch.eval import (calc_metric, detector_id,
                                       latents_to_uint8, make_detector,
                                       report_metric)

        args, dev = self.args, self.device
        if self.detector is None:
            self.detector = make_detector(args.eval_detector, dev)
        g = torch.Generator(dev).manual_seed(0)

        def gen_batches():
            for _ in range(0, args.eval_nsamples, args.eval_bs):
                yield latents_to_uint8(self.ema_images(args.eval_bs, g))

        if self.rank != 0:  # a model rank samples beside rank 0
            for _ in gen_batches():
                pass
            return {}

        real = ImageFolderDataset(args.eval_refdir, args.image_size,
                                  raw_uint8=True)
        result = calc_metric(
            "fid2k_full", real_dataset=real, gen_batches=gen_batches,
            detector=self.detector,
            cache_dir=os.path.join(self.exp_dir, "stats-cache"),
            dataset_id=args.eval_refdir,
            detector_id=detector_id(args.eval_detector), device=dev)
        report_metric(result, run_dir=self.exp_dir)
        self.log(f"in-training eval: {result['results']}")
        return result

    def close(self):
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
        if self.world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    trainer = Trainer(parse_args(argv))
    try:
        trainer.fit()
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
