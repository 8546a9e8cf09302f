"""Sample a DiM or a DiT from a checkpoint on one card, the port of the
top-level `sample.py` (the reference's `sample.py`), flag for flag:

    python -m dimsum_torch.sample ODE --model DiM-L/2 --image-size 256 \
        --ckpt dimsum-L2-imagenet256.pt --path-type GVP --num-classes 1001 \
        --sampling-method dopri5 --block-type combined --bimamba-type none \
        --rms-norm --fused-add-norm --learnable-pe --cond-mamba \
        --use-attn-every-k-layers 4 --cfg-scale 1.4 --bf16 --compute-nfe \
        --vae-ckpt sd-vae-ft-ema.bin --sample-dir samples

ODE mode integrates the probability-flow ODE (dopri5 by default, the
reference's eval protocol; Euler or Heun over `--num-sampling-steps`), SDE
mode the SDE (Euler-Maruyama or Heun).  `--ckpt` is a reference `.pt` whose
"ema" (`--params ema`) or "model" (`--params raw`) weights load strictly;
without it the model takes seeded random weights.  CFG (`--cfg-scale`,
`--ada-cfg`), `--compute-nfe`, `--likelihood` (bits/dim of the samples,
with `--cfg-scale 1.0`) and `--measure-time` as in the JAX CLI.  With
`--vae-ckpt` the latents are decoded by the SD-VAE and written as PNGs,
else saved to `latents.npz`.  ODE mode's `--compute-ppl <metric>` (ppl2_zend,
ppl_zend, ppl_zfull) measures the perceptual path length of the sampler
through `--ppl-detector` (a local vgg16.pt, or `random-lpips[:seed]`) over
`--ppl-samples` pairs (default the metric's 50k) and appends it to
`metric-<metric>.jsonl` in `--sample-dir`.  Runs on the card unless
`--device cpu`.

`--model DiT-*` samples the DiT baseline through the same transport, as
the JAX CLI does.  The published DiT checkpoints are DDPM models; their
sampler, `dimsum_torch.diffusion` (`create_diffusion`, `p_sample_loop`,
`ddim_sample_loop`), is ported as a module, and as in JAX no CLI samples
through it.

`--pp k` (the JAX CLI's pipeline-parallel sampling, sample.py:57-62,
:143-165) runs the DiM's blocks as a GPipe pipeline of k stage ranks
(`parallel/pipeline.py::dim_pipeline_forward`, `--pp-microbatches`
microbatches, clamped to a divisor of the batch): the command starts k - 1
more processes of itself (spawned; ranks 1 .. k - 1, joined over a free
localhost port by `parallel.init_distributed`: one card a rank with NCCL
where there are k cards, else gloo, the ranks sharing a card as the JAX
mesh's devices do not), each rank holds its stage's blocks and samples the same
batch, and rank 0 writes the outputs and returns the record.  A DiT, and
`--compute-ppl` with `--pp`, raise.
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

from dimsum_torch.cli import (add_model_args, add_moe_args, add_ode_args,
                              add_sde_args, add_transport_args, add_vae_args,
                              build_transport, model_config)
from dimsum_torch.models.dim import (forward_with_adacfg, forward_with_cfg,
                                     random_init_)
from dimsum_torch.models.factory import model_class
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.models.vae import load_vae
from dimsum_torch.parallel.mesh import (init_distributed, shard_state_dict,
                                        tp_rank, tp_size)
from dimsum_torch.transport import Sampler
from dimsum_torch.utils.ckpt import load_torch_checkpoint
from dimsum_torch.utils.device import card_name_and_power_limit, resolve_device
from dimsum_torch.utils.png import write_png

DECODE_BATCH = 16  # images a VAE decode call, to bound its memory


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
                   choices=["ema", "raw"],
                   help="the checkpoint's EMA weights (the reference "
                        "protocol) or its raw ones (its 'model' key)")
    p.add_argument("--global-batch-size", type=int, default=32)
    p.add_argument("--num-sampling-steps", type=int, default=250)
    p.add_argument("--cfg-scale", type=float, default=1.0)
    p.add_argument("--ada-cfg", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-dir", type=str, default="samples")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel ways: the block stack staged "
                        "over this many processes (GPipe microbatches); "
                        "needs depth / pp %% 4 == 0")
    p.add_argument("--pp-microbatches", type=int, default=4)
    p.add_argument("--measure-time", action="store_true")
    p.add_argument("--compute-nfe", action="store_true")
    p.add_argument("--compute-ppl", type=str, default=None,
                   help="a perceptual path length metric (ODE mode): "
                        "ppl2_zend, ppl_zend or ppl_zfull")
    p.add_argument("--ppl-detector", type=str, default=None,
                   help="LPIPS detector: a local vgg16.pt or "
                        "random-lpips[:seed]")
    p.add_argument("--ppl-samples", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the card unless 'cpu' is asked for")
    args = p.parse_args(argv)
    args.mode = mode
    return args


def load_model(args, cfg, dev) -> torch.nn.Module:
    """The DiM or DiT of `cfg` on `dev` in eval mode with frozen weights
    (stored in the compute dtype): the checkpoint's, or seeded random ones;
    with `--scan-impl ref` every mixer takes the plain scan."""
    tp = getattr(cfg, "tp_group", None)
    with torch.device(dev):
        net = model_class(cfg)(cfg)
        # a tensor-parallel model takes its shards of the full model's
        full = net if tp is None else model_class(cfg)(
            dataclasses.replace(cfg, tp_group=None))
    if args.ckpt is None:
        print("WARNING: no --ckpt given; using random init", file=sys.stderr)
        random_init_(full, 0)
    else:
        load_torch_checkpoint(args.ckpt, full,
                              key="ema" if args.params == "ema" else "model")
        print(f"loaded {args.ckpt} ({args.params} params)", file=sys.stderr)
    if tp is not None:
        net.load_state_dict(shard_state_dict(full.state_dict(), tp_rank(tp),
                                             tp_size(tp)), strict=True)
        del full
    if args.scan_impl == "ref":
        for m in net.modules():
            if hasattr(m, "scan_impl"):
                m.scan_impl = "ref"
    return cast_weights_(net).eval().requires_grad_(False)


def model_fn_for(args, net, cfg):
    """The sampler's model: with CFG (--cfg-scale > 1 and classes) the
    guided forward (sample's --ada-cfg: the adaptive one) of a doubled
    batch [x; x] with labels [y; null], else the net."""
    if not (args.cfg_scale > 1.0 and args.num_classes > 1):
        return lambda x, t, y=None: net(x, t, y)
    ada = getattr(args, "ada_cfg", False)  # sample's flag, not sample_ddp's
    guide = forward_with_adacfg if ada else forward_with_cfg

    def model_fn(x, t, y=None):
        return guide(net, x, t, y, cfg_scale=args.cfg_scale,
                     in_channels=cfg.in_channels)

    return model_fn


def with_null_class(z, y, num_real: int):
    """The CFG-doubled batch: [z; z] and [y; null class]."""
    return (torch.cat([z, z], 0),
            torch.cat([y, torch.full_like(y, num_real)]))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_to_png(vae, samples, sample_dir: str):
    """Decode scaled latents and write one PNG each; returns the paths."""
    paths = []
    for start in range(0, samples.shape[0], DECODE_BATCH):
        imgs = vae.decode(samples[start:start + DECODE_BATCH])
        imgs = ((imgs.float() + 1) / 2 * 255).clamp(0, 255).to(torch.uint8)
        for im in imgs.permute(0, 2, 3, 1).cpu().numpy():
            path = os.path.join(sample_dir, f"{len(paths):06d}.png")
            write_png(path, im)
            paths.append(path)
    return paths


def compute_ppl(args, cfg, model_fn, dev) -> dict:
    """`--compute-ppl`: the metric over the ODE sampler (the run's method
    and steps, its CFG on a doubled batch) decoded by the VAE, with the
    noise pairs, labels and path positions drawn by eval/ppl.py's numpy
    RNG from --seed; the result is printed and appended to
    `metric-<name>.jsonl` in --sample-dir."""
    from dimsum_torch.eval import calc_metric, report_metric
    from dimsum_torch.eval.features import make_lpips

    vae = load_vae(args.vae_ckpt, dev)
    ode = Sampler(build_transport(args)).sample_ode(
        sampling_method=args.sampling_method,
        num_steps=args.num_sampling_steps, atol=args.atol, rtol=args.rtol,
        reverse=args.reverse)
    num_real = args.num_classes - (1 if args.num_classes > 1 else 0)
    use_cfg = args.cfg_scale > 1.0 and args.num_classes > 1

    @torch.no_grad()
    def sampler_fn(z, y):
        z = torch.as_tensor(z, device=dev)
        y = (torch.zeros(z.shape[0], dtype=torch.long, device=dev)
             if y is None else torch.as_tensor(y, device=dev))
        if use_cfg:
            z, y = with_null_class(z, y, num_real)
        lat = ode(z, model_fn, y=y)
        lat = lat[: lat.shape[0] // 2] if use_cfg else lat
        return vae.decode(lat).float().cpu().numpy()

    opts = dict(sampler_fn=sampler_fn,
                lpips_fn=make_lpips(args.ppl_detector, dev),
                z_shape=(cfg.in_channels, cfg.img_resolution,
                         cfg.img_resolution),
                num_classes=num_real if args.num_classes > 1 else 0,
                batch_size=max(args.global_batch_size // 2, 1),
                seed=args.seed)
    if args.ppl_samples:
        opts["num_samples"] = args.ppl_samples
    result = calc_metric(args.compute_ppl, **opts)
    report_metric(result, run_dir=args.sample_dir)
    return result


class PipelinedModel:
    """The DiM as its stage ranks run it (`dim_pipeline_forward`), called
    as the model: (x, t, y) -> output."""

    def __init__(self, net, group, num_microbatches: int):
        from dimsum_torch.parallel.pipeline import keep_stage_blocks_

        self.net = keep_stage_blocks_(net, group)
        self.group, self.num_microbatches = group, num_microbatches

    def __call__(self, x, t, y=None):
        from dimsum_torch.parallel.pipeline import dim_pipeline_forward

        return dim_pipeline_forward(self.net, x, t, y, self.group,
                                    self.num_microbatches)


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _pp_rank(argv, rank: int, k: int, port: int):
    """A stage rank > 0 of `--pp k`: the CLI's run, writing nothing."""
    torch.set_num_threads(max(1, torch.get_num_threads() // k))
    main(argv, _stage=(rank, k, port))


def main(argv=None, _stage=None) -> dict:
    """Run the CLI; returns a record of the run: the samples (latents of
    the conditional half), labels, NFE, sampling and decode seconds,
    log-likelihood, the PPL result and the files written.  With --pp k it
    starts ranks 1 .. k - 1 and is rank 0 itself."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    procs, rank = [], 0
    if args.pp > 1:
        from dimsum_torch.parallel.pipeline import check_pipeline

        if args.compute_ppl:
            raise NotImplementedError("--compute-ppl with --pp: run the "
                                      "metric without the pipeline")
        if "DiM" not in args.model:
            raise NotImplementedError("--pp stages a DiM's blocks")
        check_pipeline(model_config(args), args.pp)  # before any rank
        if _stage is None:  # rank 0: start the other stages
            import torch.multiprocessing as mp

            port = _free_port()
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=_pp_rank,
                                 args=(argv, r, args.pp, port))
                     for r in range(1, args.pp)]
            for p in procs:
                p.start()
            _stage = (0, args.pp, port)
        rank, k, port = _stage
        init_distributed(f"localhost:{port}", k, rank, args.device,
                         timeout_s=900.0)
    try:
        return _main(args, rank)
    finally:
        if args.pp > 1:
            dist.destroy_process_group()
        for p in procs:
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(f"--pp stage process exited with "
                                   f"{p.exitcode}")


def _main(args, rank: int) -> dict:
    ppl = args.mode == "ODE" and args.compute_ppl
    if ppl and not args.ppl_detector:
        raise SystemExit("--compute-ppl needs --ppl-detector (vgg16.pt or "
                         "'random-lpips[:seed]')")
    if ppl and not args.vae_ckpt:
        raise SystemExit("--compute-ppl needs --vae-ckpt to decode")
    if args.label_dropout < 0:
        args.label_dropout = 0.1 if args.num_classes > 1 else 0.0
    use_cfg = args.cfg_scale > 1.0 and args.num_classes > 1
    likelihood = args.mode == "ODE" and args.likelihood
    if likelihood and use_cfg:
        raise SystemExit(
            "--likelihood requires --cfg-scale 1.0 (guided likelihood is "
            "ill-defined; the reference makes the same restriction)")
    cfg = model_config(args)
    transport = build_transport(args)
    dev = resolve_device(args.device)
    if args.pp > 1 and dev.type == "cuda":
        from dimsum_torch.ops import cuda_build
        from dimsum_torch.utils.device import rank_device

        dev = rank_device(args.device, rank)
        torch.cuda.set_device(dev)
        cuda_build.build()
    net = load_model(args, cfg, dev)
    if args.pp > 1:
        net = PipelinedModel(net, dist.group.WORLD, args.pp_microbatches)
    sampler = Sampler(transport)

    n = args.global_batch_size
    latent = cfg.img_resolution
    g = torch.Generator(device=dev).manual_seed(args.seed)
    z = torch.randn((n, cfg.in_channels, latent, latent), generator=g,
                    device=dev)
    num_real = args.num_classes - (1 if args.num_classes > 1 else 0)
    y = torch.randint(0, max(num_real, 1), (n,), generator=g, device=dev)
    if use_cfg:
        z, y = with_null_class(z, y, num_real)
    model_fn = model_fn_for(args, net, cfg)

    if args.mode == "ODE":
        ode = sampler.sample_ode(
            sampling_method=args.sampling_method,
            num_steps=args.num_sampling_steps, atol=args.atol,
            rtol=args.rtol, reverse=args.reverse,
            return_nfe=args.compute_nfe)

        def run():
            return ode(z, model_fn, y=y)
    else:
        sde = sampler.sample_sde(
            sampling_method=args.sampling_method,
            diffusion_form=args.diffusion_form,
            diffusion_norm=args.diffusion_norm, last_step=args.last_step,
            last_step_size=args.last_step_size,
            num_steps=args.num_sampling_steps)

        def run():
            return sde(z, model_fn, generator=torch.Generator(
                device=dev).manual_seed(args.seed + 1), y=y)

    record = {"mode": args.mode, "nfe": None, "logp": None, "bpd": None,
              "images": [], "latents_path": None}
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        out = run()
        _sync(dev)
        record["seconds"] = time.perf_counter() - t0
    if isinstance(out, tuple):
        out, record["nfe"] = out
        if rank == 0:
            print(f"NFE: {record['nfe']}")
    samples = out[:n] if use_cfg else out
    record.update(samples=samples, labels=y[:n])

    if likelihood:
        lik = sampler.sample_ode_likelihood(
            num_steps=args.num_sampling_steps, atol=args.atol,
            rtol=args.rtol)
        logp, _ = lik(samples, model_fn, generator=torch.Generator(
            device=dev).manual_seed(args.seed + 1), y=y[:n])
        dims = float(np.prod(samples.shape[1:]))
        bpd = -logp / dims / np.log(2)
        record.update(logp=logp, bpd=bpd)
        print(f"log-likelihood: mean logp={logp.mean().item():.2f} "
              f"({bpd.mean().item():.4f} bits/dim)")

    if ppl:
        record["ppl"] = compute_ppl(args, cfg, model_fn, dev)

    if args.measure_time:
        reps = 5
        with torch.no_grad():
            run()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            _sync(dev)
        dt = (time.perf_counter() - t0) / reps
        card = (card_name_and_power_limit(dev.index or 0)
                if dev.type == "cuda" else "cpu")
        record["measured_seconds"] = dt
        print(f"sampling time: {dt:.3f}s / batch ({n / dt:.3f} img/s) on "
              f"{card}")

    if rank != 0:  # a stage rank of --pp: rank 0 writes
        return record
    os.makedirs(args.sample_dir, exist_ok=True)
    if args.vae_ckpt:
        vae = load_vae(args.vae_ckpt, dev)
        with torch.no_grad():
            _sync(dev)
            t0 = time.perf_counter()
            record["images"] = decode_to_png(vae, samples, args.sample_dir)
            record["decode_seconds"] = time.perf_counter() - t0
        print(f"wrote {len(record['images'])} images to {args.sample_dir}")
    else:
        path = os.path.join(args.sample_dir, "latents.npz")
        np.savez(path, latents=samples.float().cpu().numpy(),
                 labels=y[:n].cpu().numpy())
        record["latents_path"] = path
        print(f"no --vae-ckpt: wrote raw latents to {path}")
    return record


if __name__ == "__main__":
    main()
