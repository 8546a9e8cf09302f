"""Operations, parameters, memory and throughput of a DiM forward, the port
of the top-level `flops.py` (the reference's eval_toolbox/compute_flops.py:
calflops operations and throughput and memory probes).

    python -m dimsum_torch.flops --model DiM-L/2 --image-size 256 --batch 1 \\
        [--measure-throughput] [--device cuda]

Prints one JSON line with the JAX script's keys: `model`, `params_M`,
`forward_gflops`, `peak_bytes_GB` and, with --measure-throughput,
`forward_ms`, `img_per_sec` and `achieved_tflops`.  The model is the JAX
script's (RMSNorm, CondMamba, learnable PE, attention every 4th block),
with seeded random weights, on the card unless --device cpu.

`forward_gflops` counts matrix products, convolutions and attention with
`torch.utils.flop_counter.FlopCounterMode` on the forward's plain routes
(the reference's calflops convention): the port's kernels launch through
ctypes and are invisible to the counter.  XLA's count, which the JAX
script prints, also includes elementwise work, so the two differ by that
share.  `peak_bytes_GB` is `torch.cuda.max_memory_allocated` over one
forward on the kernels' route (the weights included; null on the CPU);
`forward_ms` is that route's wall time per forward, the card synchronised.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from dimsum_torch.utils.device import resolve_device
from dimsum_torch.utils.profiling import flops, memory, timed

_ROUTES = ("scan_impl", "attn_impl", "norm_impl", "conv_impl")


@contextlib.contextmanager
def plain_routes(model):
    """Every kernel site of `model` on its plain version (impl "ref") for
    the block, as it was afterwards."""
    saved = [(m, k, getattr(m, k)) for m in model.modules() for k in _ROUTES
             if hasattr(m, k)]
    for m, k, _ in saved:
        setattr(m, k, "ref")
    try:
        yield model
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def build(model_name: str, image_size: int, num_classes: int = 1000,
          block_type: str = "combined", device="cuda"):
    """The JAX script's configuration of `model_name`, seeded weights."""
    from dimsum_torch.models.dim import DiM_models, build_dim

    cfg = DiM_models[model_name](
        img_resolution=image_size // 8, num_classes=num_classes,
        rms_norm=True, block_type=block_type, cond_mamba=True,
        learnable_pe=True, use_attn_every_k_layers=4)
    return cfg, build_dim(cfg, resolve_device(device), seed=0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, default="DiM-L/2")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--block-type", type=str, default="combined")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--measure-throughput", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the card unless 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, model = build(args.model, args.image_size, args.num_classes,
                       args.block_type, dev)
    n_params = sum(q.numel() for q in model.parameters())
    res = cfg.img_resolution
    x = torch.zeros(args.batch, cfg.in_channels, res, res, device=dev)
    t = torch.zeros(args.batch, device=dev)
    y = torch.zeros(args.batch, dtype=torch.long, device=dev)
    with torch.inference_mode():
        with plain_routes(model):
            n_flops = flops(model, x, t, y)
        peak = (memory(model, x, t, y)["peak_bytes"] if dev.type == "cuda"
                else None)
        out = {
            "model": args.model,
            "params_M": round(n_params / 1e6, 2),
            "forward_gflops": round(n_flops / 1e9, 2),
            "peak_bytes_GB": None if peak is None else round(peak / 1e9, 3),
        }
        if args.measure_throughput:
            dt = timed(model, x, t, y, iters=10, warmup=1)
            out["forward_ms"] = round(dt * 1e3, 3)
            out["img_per_sec"] = round(args.batch / dt, 2)
            if n_flops > 0:
                out["achieved_tflops"] = round(n_flops / dt / 1e12, 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
