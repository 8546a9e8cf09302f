"""The benchmark of the port (`dimsum_torch`) on one card:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

loads the cell `perfbench/workloads/<cell>.json` and its configuration
`perfbench/configs/<config>.json`, makes the weights and the inputs from
the seed on the card, warms up, measures for `--seconds`, checks what the
timed path produced against the plain reference, and prints one JSON line
last on standard output: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics of BENCHMARK.json, or with `--trace 1` its
per-layer ones, each read by `perfbench/metrics/<name>.py`), `device`,
`breakdown` (traced runs) and `checks`, each number compared beside its
limit.  Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; if JAX or the JAX package is loaded once the window
has closed, it exits 3.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

from perfbench.common import (BUILD, ROOT, SETUP, benchmark, load_cell, mark,
                              process_seconds)

FORBIDDEN = ("jax", "jaxlib", "flax", "dimsum_tpu")


def _fixed_caches():
    """Every build and kernel cache at a fixed path in the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "extensions"))


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The names of the metrics a run of `cell` reports: the end-to-end
    ones, or the per-layer ones with --trace 1, that name the cell in
    their `workloads` (or have no such list)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx):
    """`perfbench/metrics/<name>.py`'s `read(ctx)`: a number or None."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    _fixed_caches()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = benchmark()
    mark("imports")
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    runner = importlib.import_module(f"perfbench.entries.{cell['entry']}")
    ctx, checks, attempted, failed = runner.run(
        cell, args.seed, args.seconds, bool(args.trace), dev,
        setup_clock=process_seconds)
    found = loaded_forbidden()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": entry["chips"],
              "memory_peak_bytes": int(ctx.counters["memory_peak_bytes"])}
    result = {"correct": all(c.ok for c in checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {c.name: c.as_dict() for c in checks}
    starts = [0.0] + [s for _, s in SETUP]
    print("setup " + ", ".join(f"{p} {s - s0:.2f} s" for (p, s), s0
                               in zip(SETUP, starts)), file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
