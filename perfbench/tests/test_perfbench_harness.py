"""The harness without a card: what it imports, the window's arithmetic,
the weights' names against the port's, and a run that finds no card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import readers
from perfbench.common import CHECKOUT, Ctx, Window, WindowClosed, load_cell


def test_no_jax_and_a_reference_free_of_the_port():
    code = (
        "import sys\n"
        "import perfbench.reference, perfbench.reference.train, "
        "perfbench.reference.sampling\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import perfbench.run, perfbench.entries.sample, "
        "perfbench.entries.train, perfbench.trace, perfbench.readers\n"
        "from perfbench.entries import port\n"
        "from perfbench.common import load_cell\n"
        "port.model_config(load_cell('dim-l2.sample-256')['model'])\n"
        "every = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(ref); print(every)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.splitlines()
    ref, every = eval(out[-2]), eval(out[-1])
    assert "dimsum_torch" not in ref
    assert "dimsum_torch" in every
    assert not {"jax", "jaxlib", "flax", "dimsum_tpu"} & set(every)


def test_window_counts_whole_calls_over_all_their_time():
    w = Window(0.2)
    w.start()
    calls = 0
    with pytest.raises(WindowClosed):
        while True:
            w.tick()
            time.sleep(0.03)
            calls += 1
    wall = w.stop(lambda: time.sleep(0.05))
    assert w.calls == calls and 6 <= calls <= 8
    assert wall >= 0.03 * calls + 0.05
    ctx = Ctx(cell={}, window_s=wall, calls=w.calls, images_per_call=2.0,
              flops_per_call=1e12)
    assert readers.rate(ctx) == pytest.approx(2.0 * calls / wall)
    assert readers.mfu(ctx) == pytest.approx(
        100 * 1e12 * calls / (wall * 989e12))
    assert readers.idle(ctx) is None and readers.roofline(ctx, "scan") is None


def test_roofline_reads_only_the_launches_its_bound_counts():
    from perfbench.counts.model import Bound
    from perfbench.trace import Trace

    kernels = [("scan_fwd_kernel<16>", "selective_scan", 2e-3)] * 8
    trace = Trace(window_s=1.0, busy_s=0.5, calls=4, kernels=kernels,
                  gaps=[])
    ctx = Ctx(cell={}, trace=trace, bounds={"scan": Bound(1e-3, 2)})
    assert readers.roofline(ctx, "scan", "selective_scan") == \
        pytest.approx(100 * 4e-3 / 16e-3)
    ctx.bounds = {"scan": Bound(1e-3, 3)}
    assert readers.roofline(ctx, "scan", "selective_scan") is None


def test_window_stops_at_a_call_count():
    w = Window(1e9, limit_calls=3)
    w.start()
    with pytest.raises(WindowClosed):
        for _ in range(10):
            w.tick()
    assert w.calls == 3


@pytest.mark.parametrize("name", ["dim-l2.sample-256", "dit-xl2.sample-512"])
def test_weights_load_into_the_port_strictly(name):
    """The reference's names and shapes are the port's state dict's,
    at a narrow width of the same configuration."""
    from perfbench import reference
    from perfbench.entries import port
    from perfbench.weights import make_weights

    cell = load_cell(name)
    cfg = dict(cell["model"], img_resolution=8)
    if cfg["family"] == "dim":
        cfg.update(zoo="DiM-S/2", hidden_size=256, depth=4)
    else:
        cfg.update(zoo="DiT-S/2", hidden_size=384, depth=12, num_heads=6)
    ref = reference.model.build(cfg)
    w = make_weights(ref, 2 ** 31 + 5, "cpu")
    net = port.build(cfg, w, "cpu")
    assert set(net.state_dict()) == set(w)
    again = make_weights(ref, 2 ** 31 + 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "dim-l2.sample-256", "--seed", str(2 ** 31 + 11), "--seconds", "5",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=300, env=env)
    assert p.returncode != 0
    assert "metrics" not in p.stdout
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
