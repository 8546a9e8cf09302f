"""`python -m dimsum_torch.sample` on the CPU (`--device cpu`), with a
narrow DiM (DiM-S/2 at 128 px: latent 16, L 64) saved as a reference-layout
checkpoint and a small VAE (ch 32, ch_mult (1, 2)) saved in the diffusers
layout:

  * ODE dopri5 with CFG: the PNGs are written, one per sample, and read
    back with `zlib` they hold the VAE's decode of the samples; the printed
    NFE is the sampler's own, run on the same model and inputs;
  * `--params raw` samples with the checkpoint's "model" weights;
  * SDE mode runs and saves the latents; `--likelihood` gives finite
    bits/dim at cfg 1.0 and is refused with guidance;
  * `--pp` and the JAX opt-in switches the port lacks raise, a DiT and a
    MoE, cpe, cond_init DiM sample (every model of the JAX factory
    builds through `cli.model_config`), `--compute-ppl`
    without `--ppl-detector` exits asking for it (the metric itself:
    tests/test_torch_eval_ppl.py), and without `--device cpu` the CLI asks
    for the card."""

import argparse

import numpy as np
import pytest
import torch

from dimsum_torch import sample as cli
from dimsum_torch.models.dim import DiM, DiM_models, forward_with_cfg
from dimsum_torch.models.dim import random_init_
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.models.vae import load_vae
from dimsum_torch.transport import Sampler, create_transport
from dimsum_torch.utils.png import read_png, write_png
from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_vae import SMALL, seeded_vae

MODEL = ["--model", "DiM-S/2", "--image-size", "128", "--num-classes", "11",
         "--block-type", "combined", "--bimamba-type", "none", "--rms-norm",
         "--cond-mamba", "--learnable-pe", "--use-attn-every-k-layers", "4",
         "--path-type", "GVP", "--device", "cpu"]


def _dim(seed):
    cfg = DiM_models["DiM-S/2"](img_resolution=16, num_classes=11,
                                label_dropout=0.1, use_attn_every_k_layers=4)
    return random_init_(DiM(cfg), seed).eval()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    ema, raw = _dim(1), _dim(2)
    torch.save({"ema": ema.state_dict(), "model": raw.state_dict(),
                "args": argparse.Namespace(model="DiM-S/2")},
               root / "ckpt.pt")
    torch.save(seeded_vae(3, **SMALL).state_dict(), root / "vae.pt")
    return root, ema, raw


def test_ode_dopri5_writes_pngs_and_the_sampler_nfe(files, tmp_path,
                                                    capsys):
    root, ema, _ = files
    out = tmp_path / "samples"
    rec = cli.main(["ODE", *MODEL, "--ckpt", str(root / "ckpt.pt"),
                    "--vae-ckpt", str(root / "vae.pt"), "--cfg-scale", "1.4",
                    "--global-batch-size", "2", "--compute-nfe",
                    "--sample-dir", str(out), "--seed", "5"])
    printed = capsys.readouterr().out
    assert f"NFE: {rec['nfe']}" in printed
    assert "wrote 2 images" in printed
    assert rec["samples"].shape == (2, 4, 16, 16)
    assert torch.isfinite(rec["samples"]).all()

    # the sampler's own NFE and samples, on the same weights and inputs
    g = torch.Generator().manual_seed(5)
    z = torch.randn((2, 4, 16, 16), generator=g)
    y = torch.randint(0, 10, (2,), generator=g)
    net = cast_weights_(ema).requires_grad_(False)
    with torch.no_grad():
        want, nfe = Sampler(create_transport("GVP", "velocity")).sample_ode(
            sampling_method="dopri5", return_nfe=True)(
            torch.cat([z, z]), lambda x, t, y=None: forward_with_cfg(
                net, x, t, y, cfg_scale=1.4),
            y=torch.cat([y, torch.full((2,), 10)]))
    assert rec["nfe"] == nfe and nfe > 13
    torch.testing.assert_close(rec["samples"], want[:2], rtol=0, atol=0)
    torch.testing.assert_close(rec["labels"], y, rtol=0, atol=0)

    # the PNGs hold the VAE's decode, as uint8 (truncated, as the JAX CLI)
    assert sorted(p.name for p in out.iterdir()) == ["000000.png",
                                                     "000001.png"]
    with torch.no_grad():
        imgs = load_vae(str(root / "vae.pt"), "cpu").decode(rec["samples"])
    imgs = ((imgs + 1) / 2 * 255).clamp(0, 255).to(torch.uint8)
    for i, path in enumerate(rec["images"]):
        got = read_png(path)
        assert got.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, imgs[i].permute(1, 2, 0).numpy())


def test_params_raw_takes_the_model_weights(files, tmp_path):
    root, ema, raw = files
    common = ["ODE", *MODEL, "--ckpt", str(root / "ckpt.pt"),
              "--sampling-method", "euler", "--num-sampling-steps", "3",
              "--global-batch-size", "1", "--sample-dir", str(tmp_path)]
    got_raw = cli.main(common + ["--params", "raw"])["samples"]
    got_ema = cli.main(common)["samples"]
    g = torch.Generator().manual_seed(0)
    z = torch.randn((1, 4, 16, 16), generator=g)
    y = torch.randint(0, 10, (1,), generator=g)
    sample = Sampler(create_transport("GVP", "velocity")).sample_ode(
        sampling_method="euler", num_steps=3)
    with torch.no_grad():
        want = sample(z, cast_weights_(raw), y=y)
    torch.testing.assert_close(got_raw, want, rtol=0, atol=0)
    assert not torch.allclose(got_raw, got_ema)
    latents = np.load(tmp_path / "latents.npz")
    np.testing.assert_array_equal(latents["latents"], got_ema.numpy())


def test_sde_mode_and_likelihood(files, tmp_path, capsys):
    root, _, _ = files
    rec = cli.main(["SDE", *MODEL, "--ckpt", str(root / "ckpt.pt"),
                    "--diffusion-form", "sigma", "--num-sampling-steps", "4",
                    "--cfg-scale", "1.4", "--global-batch-size", "2",
                    "--sample-dir", str(tmp_path)])
    assert rec["mode"] == "SDE" and torch.isfinite(rec["samples"]).all()
    assert rec["samples"].shape == (2, 4, 16, 16)

    rec = cli.main(["ODE", *MODEL, "--ckpt", str(root / "ckpt.pt"),
                    "--sampling-method", "euler", "--num-sampling-steps",
                    "3", "--likelihood", "--global-batch-size", "2",
                    "--sample-dir", str(tmp_path)])
    assert rec["bpd"].shape == (2,) and torch.isfinite(rec["bpd"]).all()
    assert "bits/dim" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="cfg-scale 1.0"):
        cli.main(["ODE", *MODEL, "--likelihood", "--cfg-scale", "1.4"])


# what the sampling CLI refuses: a pipeline the model cannot be staged
# over (DiM-S/2: 2 blocks a stage; checked before any stage rank starts),
# --compute-ppl with --pp, and what it always refused; --pp and the JAX
# switches run (below and tests/test_torch_parallel_cli.py)
@pytest.mark.parametrize("extra, env, error, match", [
    (["--pp", "2"], None, ValueError, "breaks the i%4"),
    (["--compute-ppl", "ppl2_zend"], None, SystemExit, "ppl-detector"),
    (["--pp", "2", "--compute-ppl", "ppl2_zend"], None, NotImplementedError,
     "compute-ppl with --pp"),
    (["--scan-impl", "pallas"], None, NotImplementedError, "scan-impl"),
])
def test_unported_flags_raise(extra, env, error, match, tmp_path,
                              monkeypatch):
    if env is not None:
        monkeypatch.setenv(env, "1")
    with pytest.raises(error, match=match):
        cli.main(["ODE", *MODEL, *extra, "--sample-dir", str(tmp_path)])


@pytest.mark.parametrize("env", ["DIMSUM_FLASH_ATTN", "DIMSUM_FULL_ATTN",
                                 "DIMSUM_NORM_MXU", "DIMSUM_FUSED_WAVELET",
                                 "DIMSUM_DWT_CL"])
def test_samples_under_the_jax_switches(env, tmp_path, monkeypatch):
    """Each JAX opt-in switch, which the CLI refused until it was ported,
    samples (held to JAX model for model in
    tests/test_torch_model_switches.py)."""
    monkeypatch.setenv(env, "1")
    rec = cli.main(["ODE", *MODEL, "--sampling-method", "euler",
                    "--num-sampling-steps", "2", "--global-batch-size", "2",
                    "--sample-dir", str(tmp_path)])
    assert rec["samples"].shape == (2, 4, 16, 16)
    assert torch.isfinite(rec["samples"]).all()


@pytest.mark.parametrize("extra", [
    ["--model", "DiT-S/8"],
    ["--is-moe", "--num-moe-experts", "2", "--cond-init", "--pe-type",
     "cpe"],
])
def test_samples_dit_and_moe_cond_init_dim(extra, tmp_path):
    """The CLI samples a DiT and a MoE, cpe, cond_init DiM (seeded random
    weights, 2 Euler points, CFG) on the CPU."""
    rec = cli.main(["ODE", *MODEL, *extra, "--sampling-method", "euler",
                    "--num-sampling-steps", "2", "--cfg-scale", "1.4",
                    "--global-batch-size", "2", "--sample-dir",
                    str(tmp_path)])
    assert rec["samples"].shape == (2, 4, 16, 16)
    assert torch.isfinite(rec["samples"]).all()


def test_the_card_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [a for a in MODEL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["ODE", *argv, "--sample-dir", str(tmp_path)])


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    data = bytearray((tmp_path / "a.png").read_bytes())
    data[40] ^= 1
    (tmp_path / "b.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(tmp_path / "b.png"))
