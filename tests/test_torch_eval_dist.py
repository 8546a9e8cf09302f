"""The port's metric CLIs as 2 processes on the CPU (gloo over
tcp://localhost, spawned as tests/test_torch_ddp.py spawns its ranks; this
module imports no JAX, because every rank imports it):

  * `python -m dimsum_torch.calc_metrics --num-processes 2` (both folders
    sharded into contiguous slices, the stats combined by
    all_gather_object) gives the one-process results: KID, precision and
    recall exactly (the same fp32 features in the same order, the same
    subset RNG), FID to 1e-7 relative: the moments are summed in another
    fp64 order (~1e-16 apart), and the randproj detector's 64 features
    span 19 dimensions, so the covariances are singular and the matrix
    square root of their product turns that into ~1e-8 of FID (measured
    6.6e-9); rank 1 reports nothing, rank 0 writes the real side's
    cache;
  * `python -m dimsum_torch.sample_ddp --eval-streaming --save-images` as
    2 ranks: each generates its slice (its own seed) into its own feature
    chunks, rank 0 reports finite metrics, and calc_metrics over the PNGs
    both ranks wrote gives the same KID, precision and recall exactly, and
    FID to 1e-7 relative (as above).
"""

import json
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from dimsum_torch.models.dim import DiM, DiMConfig, DiM_models, random_init_
from dimsum_torch.models.vae import AutoencoderKL, random_init_vae_
from dimsum_torch.utils.png import write_png

TIMEOUT = 240  # seconds for a group of ranks, start-up included
METRICS = "fid2k_full,kid50k_full,pr50k3_full"
TINY = dict(depth=2, hidden_size=64, patch_size=2)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One PyTorch thread (`tests/test_torch_convert.py::torch_one_thread`,
    which this module cannot import: that module imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(r, fn, argv):
    torch.set_num_threads(1)
    DiM_models["DiM-T/2"] = lambda **kw: DiMConfig(**TINY, **kw)
    fn(argv + ["--process-id", str(r)])


def _calc_metrics(argv):
    from dimsum_torch import calc_metrics

    calc_metrics.main(argv)


def _sample_ddp(argv):
    from dimsum_torch import sample_ddp

    sample_ddp.main(argv)


def _spawn(fn, argv, k=2):
    port = _free_port()
    argv = argv + ["--num-processes", str(k), "--coordinator",
                   f"localhost:{port}"]
    ctx = mp.start_processes(_rank, args=(fn, argv), nprocs=k, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks outlived {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def _folder(path, n, seed, size=32):
    rng = np.random.default_rng(seed)
    path.mkdir()
    for i in range(n):
        write_png(str(path / f"{i:03d}.png"),
                  rng.integers(0, 256, (size, size, 3)).astype(np.uint8))


def _results(run_dir):
    out = {}
    for f in sorted(run_dir.glob("metric-*.jsonl")):
        for line in f.read_text().splitlines():
            out.update(json.loads(line)["results"])
    return out


def _close(got, want):
    assert set(got) == set(want) and want
    np.testing.assert_allclose(got["fid2k_full"], want["fid2k_full"],
                               rtol=1e-7)
    for k in ("kid50k_full", "pr50k3_full_precision",
              "pr50k3_full_recall"):
        assert got[k] == want[k], k


def test_two_process_calc_metrics_equals_one(tmp_path):
    from dimsum_torch import calc_metrics

    real, gen = tmp_path / "real", tmp_path / "gen"
    _folder(real, 25, 1)  # odd counts: uneven shards
    _folder(gen, 21, 2)
    base = ["--metrics", METRICS, "--real-dir", str(real), "--gen-dir",
            str(gen), "--image-size", "32", "--batch-size", "8",
            "--device", "cpu"]
    calc_metrics.main(base + ["--cache-dir", str(tmp_path / "c1"),
                              "--run-dir", str(tmp_path / "one")])
    _spawn(_calc_metrics, base + ["--cache-dir", str(tmp_path / "c2"),
                                  "--run-dir", str(tmp_path / "two")])
    _close(_results(tmp_path / "two"), _results(tmp_path / "one"))
    assert len(list((tmp_path / "c2").glob("real-stats-*.npz"))) == 1


def test_two_process_sample_ddp_streaming(tmp_path):
    from dimsum_torch import calc_metrics

    real = tmp_path / "real"
    _folder(real, 12, 3, size=64)
    cfg = DiMConfig(**TINY, img_resolution=8, num_classes=5,
                    label_dropout=0.1, use_attn_every_k_layers=2)
    torch.save({"ema": random_init_(DiM(cfg), 1).state_dict()},
               tmp_path / "ckpt.pt")
    vae = random_init_vae_(AutoencoderKL(ch=32, ch_mult=(1, 1, 1, 1)), 2)
    torch.save(vae.state_dict(), tmp_path / "vae.pt")
    out = tmp_path / "run" / "samples"
    _spawn(_sample_ddp, [
        "ODE", "--model", "DiM-T/2", "--image-size", "64", "--num-classes",
        "5", "--block-type", "combined", "--bimamba-type", "none",
        "--rms-norm", "--cond-mamba", "--learnable-pe",
        "--use-attn-every-k-layers", "2", "--ckpt", str(tmp_path /
                                                        "ckpt.pt"),
        "--vae-ckpt", str(tmp_path / "vae.pt"), "--sampling-method", "euler",
        "--num-sampling-steps", "3", "--cfg-scale", "1.5",
        "--per-proc-batch-size", "3", "--num-fid-samples", "9",
        "--sample-dir", str(out), "--eval-refdir", str(real),
        "--eval-metric", METRICS, "--eval-streaming", "--save-images",
        "--device", "cpu"])
    streamed = _results(out)
    assert all(np.isfinite(v) for v in streamed.values())
    # rank 0: samples 0-4 (2 batches), rank 1: samples 5-8 (2 batches)
    assert [len(list((out / f"feat-chunks-rank{r}").glob("chunk*.npy")))
            for r in (0, 1)] == [2, 2]
    assert sorted(p.name for p in out.glob("*.png")) == \
        [f"{i:06d}.png" for i in range(9)]
    for line in (out / "metric-fid2k_full.jsonl").read_text().splitlines():
        assert json.loads(line)["metric"] == "fid2k_full"  # rank 0 alone
    assert len((out / "metric-fid2k_full.jsonl").read_text()
               .splitlines()) == 1
    calc_metrics.main(["--metrics", METRICS, "--real-dir", str(real),
                       "--gen-dir", str(out), "--image-size", "64",
                       "--device", "cpu", "--cache-dir",
                       str(tmp_path / "run" / "stats-cache"),
                       "--run-dir", str(tmp_path / "disk")])
    _close(_results(tmp_path / "disk"), streamed)
