"""The port's training CLI (`python -m dimsum_torch.train`, its `Trainer`)
on the CPU from a tiny latent memmap (24 samples of 4 x 8 x 8, 64 px),
with a tiny zoo entry (hidden 32, depth 4, a DiT block after every 2nd):

  * it trains, logs the window-mean loss, and writes and rotates its
    checkpoints (content keep 2, snapshots every --ckpt-every epochs);
  * with the draws injected (the transport's t and x0, the label-drop ids
    and the drop-path masks each a fixed function of the data, as
    tests/test_torch_train.py injects them), a run resumed from the
    content checkpoint ends bit for bit where an unbroken run ends
    (tolerance 0), and the resumed state equals the saved file bit for bit
    before its first step;
  * --model-ckpt warm-starts the weights and the EMA; --grad-checkpoint
    runs; --vae-ckpt writes a sample grid (a small VAE file);
  * --tp raises naming its ROADMAP.md item; --eval-refdir and a pixel
    dataset without --vae-ckpt exit asking for it (both with it:
    tests/test_torch_eval_cli.py);
  * `warmup_cosine_schedule` gives optax's value at every step of a short
    schedule, to 1e-7 relative; `save_checkpoint` keeps the newest `keep`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dimsum_torch.models.blocks as port_blocks
import dimsum_torch.train as train_cli
from dimsum_tpu.parallel.train import \
    warmup_cosine_schedule as jax_schedule
from dimsum_torch.models.dim import DiMConfig, DiM_models, build_dim
from dimsum_torch.models.vae import AutoencoderKL, random_init_vae_
from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                   warmup_cosine_schedule)
from dimsum_torch.transport import create_transport
from dimsum_torch.transport.transport import Transport
from dimsum_torch.utils.ckpt import (checkpoint_steps, restore_checkpoint,
                                     save_checkpoint)
from dimsum_torch.utils.png import read_png
from tests.test_torch_convert import torch_one_thread  # noqa: F401

N = 24


@pytest.fixture(autouse=True)
def tiny_zoo(monkeypatch):
    monkeypatch.setitem(DiM_models, "DiM-T/2", lambda **kw: DiMConfig(
        depth=4, hidden_size=32, patch_size=2, **kw))


@pytest.fixture
def datadir(tmp_path):
    rng = np.random.default_rng(0)
    rng.standard_normal((N, 4, 8, 8)).astype(np.float32).tofile(
        tmp_path / "latents.dat")
    rng.integers(0, 10, N).astype(np.int64).tofile(tmp_path / "labels.dat")
    return tmp_path


def argv(datadir, *extra, exp="run"):
    return ["--exp", exp, "--datadir", str(datadir), "--results-dir",
            str(datadir / "results"), "--dataset", "latent_memmap",
            "--model", "DiM-T/2", "--image-size", "64", "--block-type",
            "combined", "--bimamba-type", "none", "--rms-norm",
            "--cond-mamba", "--learnable-pe", "--use-attn-every-k-layers",
            "2", "--num-classes", "10", "--drop-path", "0.2",
            "--path-type", "GVP", "--global-batch-size", "4",
            "--log-every", "3", "--num-workers", "2", "--device", "cpu",
            *extra]


def run(args):
    trainer = train_cli.Trainer(train_cli.parse_args(args))
    try:
        trainer.fit()
    finally:
        trainer.close()
    return trainer


def test_trains_and_rotates_checkpoints(datadir):
    trainer = run(argv(datadir, "--epochs", "3", "--save-content-every",
                       "1", "--ckpt-every", "2", "--grad-checkpoint",
                       "--remat-policy", "scan"))
    assert trainer.cfg.grad_checkpoint and trainer.dataset.is_native
    exp = datadir / "results" / "run"
    # 6 steps an epoch, epochs 0-3: content at 6, 12, 18, 24, keep 2
    assert checkpoint_steps(exp / "content") == [18, 24]
    assert checkpoint_steps(exp / "checkpoints") == [18]
    assert trainer.train_steps == trainer.state.step == 24
    assert [h["step"] for h in trainer.history] == list(range(3, 25, 3))
    assert np.isfinite([h["loss"] for h in trainer.history]).all()
    log = (exp / "log.txt").read_text()
    assert log.count("loss=") == 8 and "saved snapshot at step 18" in log


@dataclasses.dataclass(frozen=True)
class DataKeyedDraws(Transport):
    """The transport with every draw a fixed function of the batch: t from
    the first latent entry, x0 the channel-flipped latents, the label-drop
    ids from the labels."""

    def sample(self, x1, generator=None):
        t = (x1[:, 0, 0, 0].abs() * 0.3).clamp(0.05, 0.95)
        return t, x1.flip(1) * 0.5, x1

    def training_losses(self, model_fn, x1, generator=None,
                        model_kwargs=None):
        kw = dict(model_kwargs)
        kw["force_drop_ids"] = (kw["y"] % 3 == 0).long()
        return super().training_losses(model_fn, x1, generator, kw)


def data_keyed_transport():
    """The GVP velocity transport with `DataKeyedDraws`."""
    base = create_transport("GVP", "velocity")
    return DataKeyedDraws(**{f.name: getattr(base, f.name)
                             for f in dataclasses.fields(Transport)})


def inject_draws(monkeypatch):
    monkeypatch.setattr(train_cli, "build_transport",
                        lambda args: data_keyed_transport())

    def drop_path(x, rate, generator=None):
        keep = (x.flatten(1)[:, 0] > 0).to(x.dtype)
        return x * keep.reshape((-1,) + (1,) * (x.ndim - 1)) / (1 - rate)

    monkeypatch.setattr(port_blocks, "drop_path_fn", drop_path)


def _content(exp_dir):
    step = checkpoint_steps(exp_dir / "content")[-1]
    return torch.load(exp_dir / "content" / f"{step:07d}.pt",
                      map_location="cpu", weights_only=False)


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for key in ("model", "ema"):
        assert set(a[key]) == set(b[key])
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    sa, sb = a["opt"]["state"], b["opt"]["state"]
    assert set(sa) == set(sb)
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_resumed_run_ends_where_unbroken_run_ends(datadir, monkeypatch):
    inject_draws(monkeypatch)
    common = ("--save-content-every", "1", "--ema-decay", "0.9")
    run(argv(datadir, "--epochs", "2", *common, exp="whole"))
    run(argv(datadir, "--epochs", "0", *common, exp="split"))
    args = train_cli.parse_args(argv(datadir, "--epochs", "2", "--resume",
                                     *common, exp="split"))
    trainer = train_cli.Trainer(args)
    try:
        assert (trainer.train_steps, trainer.init_epoch) == (6, 1)
        saved = _content(datadir / "results" / "split")
        model = trainer.state.model
        _assert_same_state(saved, {
            "step": trainer.state.step, "model": model.state_dict(),
            "ema": trainer.state.ema_params,
            "opt": trainer.state.optimizer.state_dict()})
        trainer.fit()
    finally:
        trainer.close()
    whole = _content(datadir / "results" / "whole")
    split = _content(datadir / "results" / "split")
    assert whole["step"] == split["step"] == 18
    _assert_same_state(whole, split)


def test_warm_start_and_sample_grid(datadir):
    """--model-ckpt loads a reference `.pt`'s "model" weights into the
    weights and the EMA; --vae-ckpt (a small VAE written as a diffusers
    state dict) gives one grid of min(eval_bs * 4, 16) samples at epoch
    0."""
    cfg = DiM_models["DiM-T/2"](img_resolution=8, num_classes=10,
                                use_attn_every_k_layers=2)
    donor = build_dim(cfg, "cpu", seed=9, train=True)
    torch.save({"model": donor.state_dict(), "ema": {}},
               datadir / "donor.pt")
    with torch.device("cpu"):
        vae = random_init_vae_(AutoencoderKL(ch=32, ch_mult=(1, 2)), 0)
    torch.save(vae.state_dict(), datadir / "vae.pt")
    trainer = train_cli.Trainer(train_cli.parse_args(argv(
        datadir, "--epochs", "0", "--model-ckpt", str(datadir / "donor.pt"),
        "--vae-ckpt", str(datadir / "vae.pt"), "--eval-bs", "1",
        "--plot-every", "1")))
    try:
        for name, p in trainer.state.model.named_parameters():
            want = donor.state_dict()[name]
            assert torch.equal(p.detach(), want), name
            assert torch.equal(trainer.state.ema_params[name], want), name
        trainer.fit()
    finally:
        trainer.close()
    grid = read_png(str(datadir / "results" / "run" /
                        "samples_epoch00000.png"))
    assert grid.shape == (2 * 16, 2 * 16, 3)  # 4 samples of 16 x 16 px


@pytest.mark.parametrize("flags,error,match", [
    (("--tp", "2"), ValueError, "does not divide 1 processes"),
    (("--eval-refdir", "ref"), SystemExit, "needs --vae-ckpt"),
    (("--dataset", "imagenet"), SystemExit, "in pixels")])
def test_unported_flags_raise(datadir, flags, error, match):
    with pytest.raises(error, match=match):
        train_cli.Trainer(train_cli.parse_args(argv(datadir, *flags)))


def test_warmup_cosine_schedule_matches_optax():
    model = torch.nn.Linear(2, 2)
    opt = create_optimizer(model, lr=1.0)
    kw = dict(lr=3e-4, min_lr=1e-6, warmup_epochs=2, total_epochs=7,
              steps_per_epoch=3)
    sched = warmup_cosine_schedule(opt, **kw)
    want = jax_schedule(**kw)
    for step in range(25):
        got = opt.param_groups[0]["lr"]
        np.testing.assert_allclose(got, float(want(step)), rtol=1e-7,
                                   atol=0, err_msg=str(step))
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-6)


def test_save_checkpoint_keeps_the_newest(tmp_path):
    cfg = DiM_models["DiM-T/2"](img_resolution=8, num_classes=10)
    model = build_dim(cfg, "cpu", seed=0, train=True)
    state = create_train_state(model, create_optimizer(model))
    for step in (5, 10, 15, 20):
        state.step = step
        save_checkpoint(str(tmp_path / "c"), state, step=step, keep=3)
    assert checkpoint_steps(tmp_path / "c") == [10, 15, 20]
    assert not list((tmp_path / "c").glob("*.tmp"))
    other = build_dim(cfg, "cpu", seed=1, train=True)
    fresh = create_train_state(other, create_optimizer(other))
    assert restore_checkpoint(str(tmp_path / "none"), fresh) == (None, None)
    restored, step = restore_checkpoint(str(tmp_path / "c"), fresh)
    assert step == 20 and restored.step == 20
    for name, p in restored.model.named_parameters():
        assert torch.equal(p, dict(model.named_parameters())[name])
    _, step = restore_checkpoint(str(tmp_path / "c"), fresh, step=10)
    assert step == 10 and fresh.step == 10
