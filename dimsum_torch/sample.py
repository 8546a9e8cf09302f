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

Not ported yet, and refused: `--pp` (ROADMAP.md Queue 1 item 8); what
`dimsum_torch.models.factory.model_config` refuses.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from dimsum_torch.cli import (add_model_args, add_moe_args, add_ode_args,
                              add_sde_args, add_transport_args, add_vae_args,
                              build_transport, model_config)
from dimsum_torch.models.dim import (forward_with_adacfg, forward_with_cfg,
                                     random_init_)
from dimsum_torch.models.factory import model_class
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.models.vae import load_vae
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
                   help="pipeline-parallel ways (not ported: ROADMAP.md "
                        "Queue 1 item 8)")
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
    with torch.device(dev):
        net = model_class(cfg)(cfg)
    if args.ckpt is None:
        print("WARNING: no --ckpt given; using random init", file=sys.stderr)
        random_init_(net, 0)
    else:
        load_torch_checkpoint(args.ckpt, net,
                              key="ema" if args.params == "ema" else "model")
        print(f"loaded {args.ckpt} ({args.params} params)", file=sys.stderr)
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


def main(argv=None) -> dict:
    """Run the CLI; returns a record of the run: the samples (latents of
    the conditional half), labels, NFE, sampling and decode seconds,
    log-likelihood, the PPL result and the files written."""
    args = parse_args(argv)
    if args.pp > 1:
        raise NotImplementedError(
            "--pp (pipeline-parallel sampling): not ported to dimsum_torch "
            "yet (ROADMAP.md Queue 1 item 8)")
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
    net = load_model(args, cfg, dev)
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
