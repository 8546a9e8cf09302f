"""The port's data-parallel train step (`make_train_step(..., group=g)`)
in 2 gloo processes on the CPU against one process that replays both
ranks' micro-batches in turn with the same per-rank draws, as the JAX
package holds its DP step (tests/test_parallel.py:115-145, :208-247): the
loss, the weights and the EMA after 2 steps, with grad_accum 1 and 2, and
with 4 ranks.  Also
the training CLI as 2 ranks (the Trainer's stripes, seeds and group) and
`init_distributed`'s arguments.

The ranks are spawned processes joined over a `file://` store under the
test's tmp_path, with one thread each, as in
tests/test_torch_seq_parallel.py; this module imports no JAX, because every
rank imports it.  The model is a tiny DiM (hidden 32, depth 4, latent 8)
with stochastic depth 0.3 and label dropout 0.1, so that every rank's
generator (seeded global_seed * 2 + rank) matters.

Tolerances (those of the JAX test): the loss rtol 1e-6, the weights and
the EMA atol 2e-6 and rtol 1e-5.  The replay sums the same gradients in
another order (all micro-batches into one sum, then / 4, where a rank sums
its 2 and the all-reduce the ranks'); with 2 ranks and grad_accum 1 the
two orders coincide and the results are equal bit for bit (measured).  With
grad_accum 2 the entries whose gradient is rounding noise in a step (below
1e-3 of its tensor's largest, such as the attention key biases, whose true
gradient is 0) take AdamW steps of lr * noise / eps that hang on the order
of the sums (measured 3.8e-6 at lr 1e-3): those are held to 2 lr a step
instead, as tests/test_torch_train.py holds them.
"""

import datetime
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dimsum_torch.models.dim import DiMConfig, DiM_models, build_dim
from dimsum_torch.parallel import (clip_by_global_norm, create_optimizer,
                                   create_train_state, ema_update,
                                   init_distributed, make_train_step)
from dimsum_torch.transport import create_transport

K, STEPS, BATCH, SEED, LR, EMA = 2, 2, 4, 7, 1e-3, 0.9
TIMEOUT = 120  # seconds for a group of ranks, start-up included
TINY = dict(img_resolution=8, hidden_size=32, depth=4, num_classes=10,
            use_attn_every_k_layers=2, label_dropout=0.1, drop_path=0.3)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One PyTorch thread (`tests/test_torch_convert.py::torch_one_thread`,
    which this module cannot import: that module imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank(r, fn, k, store, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=k, rank=r,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        fn(r, k, *args)
    finally:
        dist.destroy_process_group()


def _spawn(fn, tmp_path, *args, k=K, init=_rank):
    """fn(rank, k, *args) in k spawned ranks (joined by `init`); raises if
    one fails or the group outlives TIMEOUT (then every rank is
    terminated)."""
    ctx = mp.start_processes(init, args=(fn, k, str(tmp_path / "store"),
                                         *args),
                             nprocs=k, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running "
                                   f"after {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((STEPS, BATCH, 4, 8, 8)).astype(np.float32)
    y = rng.integers(0, 10, (STEPS, BATCH)).astype(np.int64)
    return x, y


def _state():
    model = build_dim(DiMConfig(**TINY), "cpu", seed=3, train=True)
    return create_train_state(model, create_optimizer(model, lr=LR))


def _snapshot(state, losses):
    out = {"losses": np.asarray(losses)}
    for n, p in state.model.named_parameters():
        out[f"p:{n}"] = p.detach().numpy().copy()
        out[f"e:{n}"] = state.ema_params[n].numpy().copy()
    return out


def _dp_rank(r, k, path, accum):
    x, y = _data()
    state = _state()
    step = make_train_step(state.model, create_transport("GVP", "velocity"),
                           state.optimizer, ema_decay=EMA, grad_accum=accum,
                           group=dist.group.WORLD)
    g = torch.Generator().manual_seed(SEED * k + r)
    per = BATCH // k
    losses = [step(state, torch.from_numpy(x[s, r * per:(r + 1) * per]),
                   torch.from_numpy(y[s, r * per:(r + 1) * per]),
                   g)["loss"].item() for s in range(STEPS)]
    np.savez(f"{path}/rank{r}.npz", **_snapshot(state, losses))


def _replay(accum, k=K):
    """One process: each step, rank 0's micro-batches, then rank 1's, ...,
    each with its rank's generator, the gradients summed and divided by
    their count, then the same clip, AdamW and EMA."""
    x, y = _data()
    state = _state()
    model, params = state.model, list(state.model.parameters())
    transport = create_transport("GVP", "velocity")
    gens = [torch.Generator().manual_seed(SEED * k + r) for r in range(k)]
    per, losses = BATCH // k, []
    noise = {n: np.zeros(p.shape, bool) for n, p in model.named_parameters()}
    for s in range(STEPS):
        for p in params:
            p.grad = None
        step_losses = []
        for r in range(k):
            xr = torch.from_numpy(x[s, r * per:(r + 1) * per])
            yr = torch.from_numpy(y[s, r * per:(r + 1) * per])
            for xi, yi in zip(xr.chunk(accum), yr.chunk(accum)):
                def model_fn(xt, t, **kw):
                    return model(xt, t, train=True, generator=gens[r], **kw)
                loss = transport.training_losses(
                    model_fn, xi, gens[r], {"y": yi})["loss"].mean()
                loss.backward()
                step_losses.append(loss.detach())
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.div_(k * accum)
        for n, p in model.named_parameters():
            g = p.grad.abs().numpy()
            noise[n] |= g <= 1e-3 * max(g.max(), 1e-30)
        losses.append((sum(step_losses) / (k * accum)).item())
        clip_by_global_norm(params, 1.0)
        state.optimizer.step()
        ema_update(state.ema_params, model, EMA)
    return _snapshot(state, losses), noise


@pytest.mark.parametrize("k, accum", [(2, 1), (2, 2), (4, 1)])
def test_dp_step_equals_sequential_replay(k, accum, tmp_path):
    _spawn(_dp_rank, tmp_path, str(tmp_path), accum, k=k)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(k)]
    want, noise = _replay(accum, k)
    for r in range(1, k):  # the ranks hold one replica
        for key in want:
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key],
                                          err_msg=key)
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    assert got["losses"][0] != got["losses"][1]
    for key in want:
        if key != "losses":
            tol = np.where(noise[key[2:]], 2 * LR * STEPS,
                           2e-6 + 1e-5 * np.abs(want[key]))
            assert (np.abs(got[key] - want[key]) <= tol).all(), key
    if (k, accum) == (2, 1):  # the sums' orders coincide
        assert all(np.array_equal(got[key], want[key]) for key in want)


# --------------------------------------------------------------------------
# the CLI as 2 ranks
# --------------------------------------------------------------------------

def _cli_rank(r, k, store, port, root):
    """One rank of the training CLI: the Trainer joins the group itself
    (gloo over tcp://localhost:port) and saves its final weights."""
    from dimsum_torch.train import Trainer, parse_args

    torch.set_num_threads(1)
    DiM_models["DiM-T/2"] = lambda **kw: DiMConfig(
        depth=2, hidden_size=32, patch_size=2, **kw)
    argv = ["--exp", "ddp", "--datadir", root, "--results-dir",
            f"{root}/results", "--dataset", "latent_memmap", "--model",
            "DiM-T/2", "--image-size", "64", "--block-type", "combined",
            "--bimamba-type", "none", "--rms-norm", "--cond-mamba",
            "--learnable-pe", "--use-attn-every-k-layers", "2",
            "--num-classes", "10", "--global-batch-size", "4", "--epochs",
            "1", "--log-every", "2", "--save-content-every", "1",
            "--ckpt-every", "1", "--num-workers", "1", "--device", "cpu",
            "--num-processes", str(k), "--process-id", str(r),
            "--coordinator", f"localhost:{port}"]
    trainer = Trainer(parse_args(argv))
    try:
        trainer.fit()
        assert trainer.loader.shard_id == r and trainer.world == k
        np.savez(f"{root}/final{r}.npz", **_snapshot(
            trainer.state, [h["loss"] for h in trainer.history]))
    finally:
        trainer.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _no_init(r, fn, k, store, *args):
    fn(r, k, store, *args)


def test_cli_trains_as_two_ranks(tmp_path):
    rng = np.random.default_rng(1)
    rng.standard_normal((16, 4, 8, 8)).astype(np.float32).tofile(
        tmp_path / "latents.dat")
    rng.integers(0, 10, 16).astype(np.int64).tofile(tmp_path / "labels.dat")
    _spawn(_cli_rank, tmp_path, _free_port(), str(tmp_path), init=_no_init)
    finals = [dict(np.load(tmp_path / f"final{r}.npz")) for r in range(K)]
    for key in finals[0]:
        np.testing.assert_array_equal(finals[1][key], finals[0][key],
                                      err_msg=key)
    # 16 samples, 2 a rank a step: 4 steps an epoch, epochs 0 and 1
    assert len(finals[0]["losses"]) == 4
    run = tmp_path / "results" / "ddp"
    assert sorted(p.name for p in (run / "content").iterdir()) == [
        "0000004.pt", "0000008.pt"]
    assert [p.name for p in (run / "checkpoints").iterdir()] == [
        "0000008.pt"]
    log = (run / "log.txt").read_text()
    assert "2 process(es)" in log and log.count("loss=") == 4


def test_init_distributed_arguments():
    assert init_distributed(num_processes=1) == 0
    assert not dist.is_initialized()
    for bad in (None, 2, -1):
        with pytest.raises(ValueError, match="process-id"):
            init_distributed(num_processes=2, process_id=bad, device="cpu")
