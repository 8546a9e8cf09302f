"""The port's CLIs with parallelism beyond DDP, on the CPU:

  * `train --tp 2` (and `--is-moe --tp 2`, expert parallelism) as 2 gloo
    ranks: both ranks log the same losses, the content checkpoint holds the
    full, unsharded state under the reference's names, it resumes at
    --tp 1 to the same weights, and it loads into the JAX package through
    `convert_torch_state_dict` (strict);
  * `sample_ddp --tp 2` as 2 ranks: one data row, its first rank writes the
    latents, which equal the one-process run's;
  * `sample --pp 2`: the CLI starts its second stage rank itself; its
    samples equal the `--pp 1` run's.

The ranks are spawned processes (the pattern of tests/test_torch_ddp.py);
this module imports no JAX at its top, because every rank imports it.

Tolerances: the TP and PP samples 1e-5 of their scale against the
unsharded ones (the TP forward sums its partial products in another order;
the pipeline runs the same blocks on microbatches); the checkpoints bit
for bit."""

import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from dimsum_torch.models.dim import DiMConfig, DiM_models

TIMEOUT = 150
K = 2
TRAIN_ARGV = ["--dataset", "latent_memmap", "--model", "DiM-T/2",
              "--image-size", "64", "--block-type", "combined",
              "--bimamba-type", "none", "--rms-norm", "--cond-mamba",
              "--learnable-pe", "--use-attn-every-k-layers", "2",
              "--num-classes", "10", "--global-batch-size", "4",
              "--epochs", "0", "--log-every", "2",
              "--save-content-every", "1", "--num-workers", "1",
              "--device", "cpu"]
SAMPLE_ARGV = ["--model", "DiM-S8/2", "--image-size", "64",
               "--num-classes", "10", "--block-type", "combined",
               "--bimamba-type", "none", "--rms-norm", "--cond-mamba",
               "--learnable-pe", "--use-attn-every-k-layers", "4",
               "--sampling-method", "euler", "--num-sampling-steps", "2",
               "--cfg-scale", "1.5", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_zoo():
    DiM_models["DiM-T/2"] = lambda **kw: DiMConfig(
        depth=2, hidden_size=32, patch_size=2, **kw)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, *args, k=K):
    ctx = mp.start_processes(fn, args=(k, *args), nprocs=k, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def _train_rank(r, k, port, root, extra):
    from dimsum_torch.train import Trainer, parse_args

    torch.set_num_threads(1)
    _tiny_zoo()
    argv = ["--exp", "tp", "--datadir", root, "--results-dir",
            f"{root}/results", *TRAIN_ARGV, "--tp", "2", "--num-processes",
            str(k), "--process-id", str(r), "--coordinator",
            f"localhost:{port}", *extra]
    trainer = Trainer(parse_args(argv))
    try:
        assert trainer.rows == 1 and trainer.row == 0
        trainer.fit()
        np.save(f"{root}/losses{r}.npy",
                np.asarray([h["loss"] for h in trainer.history]))
    finally:
        trainer.close()


@pytest.mark.parametrize("moe", [False, True])
def test_train_tp_saves_the_full_state(tmp_path, moe):
    """`train --tp 2` (with `moe`, `--is-moe --num-moe-experts 4`: the
    experts split 2 a rank) as 2 ranks, one epoch of 4 steps."""
    import jax

    from dimsum_tpu.models.dim import DiM as JaxDiM
    from dimsum_tpu.models.dim import DiMConfig as JaxCfg
    from dimsum_tpu.utils.ckpt import convert_torch_state_dict
    from dimsum_torch.train import Trainer, parse_args

    rng = np.random.default_rng(1)
    rng.standard_normal((16, 4, 8, 8)).astype(np.float32).tofile(
        tmp_path / "latents.dat")
    rng.integers(0, 10, 16).astype(np.int64).tofile(tmp_path / "labels.dat")
    extra = ["--is-moe", "--num-moe-experts", "4"] if moe else []
    _spawn(_train_rank, _free_port(), str(tmp_path), extra)
    l0, l1 = (np.load(tmp_path / f"losses{r}.npy") for r in range(K))
    assert len(l0) == 2 and np.array_equal(l0, l1)
    ckpt = tmp_path / "results" / "tp" / "content" / "0000004.pt"
    saved = torch.load(ckpt, weights_only=False)
    assert saved["step"] == 4

    # resumed at --tp 1: the unsharded model takes the full state
    _tiny_zoo()
    argv = ["--exp", "tp", "--datadir", str(tmp_path), "--results-dir",
            str(tmp_path / "results"), *TRAIN_ARGV, "--resume", *extra]
    one = Trainer(parse_args(argv))
    try:
        assert one.train_steps == 4
        sd = one.state.model.state_dict()
        assert list(saved["model"]) == list(sd)
        for name, v in sd.items():
            assert torch.equal(saved["model"][name], v), name
        for name, v in one.state.ema_params.items():
            assert torch.equal(saved["ema"][name], v), name
        opt = one.state.optimizer.state_dict()["state"]
        assert len(opt) == len(sd) and all(
            torch.equal(opt[i]["exp_avg"], saved["opt"]["state"][i]
                        ["exp_avg"]) for i in opt)
    finally:
        one.close()
    # and into the JAX package, strictly
    jcfg = JaxCfg(img_resolution=8, patch_size=2, hidden_size=32, depth=2,
                  num_classes=10, rms_norm=True, block_type="combined",
                  cond_mamba=True, learnable_pe=True,
                  use_attn_every_k_layers=2, is_moe=moe, num_moe_experts=4,
                  gated_linear_unit=False)  # the CLI's default
    shapes = jax.eval_shape(
        JaxDiM(jcfg).init, jax.random.PRNGKey(0), np.zeros((1, 4, 8, 8)),
        np.zeros((1,)), np.zeros((1,), np.int32))["params"]
    convert_torch_state_dict({k: v.numpy() for k, v in
                              saved["model"].items()}, shapes, strict=True)


def _sample_ddp_rank(r, k, port, root):
    from dimsum_torch import sample_ddp

    torch.set_num_threads(1)
    rec = sample_ddp.main(["ODE", *SAMPLE_ARGV, "--per-proc-batch-size",
                           "2", "--num-fid-samples", "4", "--sample-dir",
                           f"{root}/tp", "--tp", "2", "--num-processes",
                           str(k), "--process-id", str(r), "--coordinator",
                           f"localhost:{port}"])
    assert rec["data_ways"] == 1 and rec["writer"] == (r == 0)
    np.save(f"{root}/latents{r}.npy", rec["latents"])


def test_sample_ddp_tp_equals_one_process(tmp_path):
    from dimsum_torch import sample_ddp

    _spawn(_sample_ddp_rank, _free_port(), str(tmp_path))
    assert (tmp_path / "tp" / "latents.npz").exists()
    assert not list((tmp_path / "tp").glob("latents_rank*"))
    tp = [np.load(tmp_path / f"latents{r}.npy") for r in range(K)]
    np.testing.assert_array_equal(tp[0], tp[1])
    one = sample_ddp.main(["ODE", *SAMPLE_ARGV, "--per-proc-batch-size", "2",
                           "--num-fid-samples", "4", "--sample-dir",
                           str(tmp_path / "one")])["latents"]
    assert one.shape == (4, 4, 8, 8)
    scale = np.abs(one).max()
    assert np.abs(tp[0] - one).max() <= 1e-5 * scale


def test_sample_pp_equals_one_process(tmp_path):
    """`sample --pp 2 --pp-microbatches 2` (its stage rank started by the
    CLI) against `--pp 1`: the CFG-doubled batch of 4 in 2 microbatches
    through 2 stages of 4 blocks."""
    from dimsum_torch import sample

    argv = [*SAMPLE_ARGV, "--global-batch-size", "2", "--sample-dir"]
    pp = sample.main(["ODE", *argv, str(tmp_path / "pp"), "--pp", "2",
                      "--pp-microbatches", "2"])
    one = sample.main(["ODE", *argv, str(tmp_path / "one")])
    want = one["samples"].numpy()
    assert pp["samples"].shape == (2, 4, 8, 8)
    assert np.abs(pp["samples"].numpy() - want).max() <= \
        1e-5 * np.abs(want).max()
    assert (tmp_path / "pp" / "latents.npz").exists()
