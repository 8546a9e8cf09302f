"""The port's evaluation CLIs on the CPU (`--device cpu`), with a tiny DiM
(hidden 64, depth 2, 64 px: latent 8), a small VAE (ch 32, four levels:
x8) and the randproj detector:

  * `sample_ddp` streaming (features from the decoded batches, in chunk
    files) and disk (PNGs, then the metrics over the folder) routes give
    the same KID, precision and recall exactly and FID to 1e-7 relative
    (randproj's singular covariances, tests/test_torch_eval_dist.py), and
    the PNGs of both routes are the same images;
  * a rerun with every chunk on disk regenerates nothing and reports the
    same metrics; with one chunk removed it generates that batch alone,
    into the same chunk bit for bit;
  * `calc_metrics` over the saved PNGs equals both routes;
  * without --vae-ckpt the latents go to latents.npz; --tp is refused;
  * `train --eval-refdir --eval-every 1` writes one finite fid2k_full to
    metric-fid2k_full.jsonl, and trains from an image folder through the
    VAE encode (a pixel dataset without --vae-ckpt is refused);
  * the tools: extract_real_samples writes the dataset's items as PNGs;
    make_synthetic_latents writes the JAX tool's latents bit for bit and
    decodes reference PNGs.
"""

import json
import runpy
import sys

import numpy as np
import pytest
import torch

from dimsum_torch import calc_metrics, sample_ddp
from dimsum_torch import train as train_cli
from dimsum_torch.data import ImageFolderDataset
from dimsum_torch.models.dim import DiM, DiMConfig, DiM_models, random_init_
from dimsum_torch.models.vae import AutoencoderKL, random_init_vae_
from dimsum_torch.tools import extract_real_samples, make_synthetic_latents
from dimsum_torch.utils.png import read_png, write_png
from tests.test_torch_convert import torch_one_thread  # noqa: F401

METRICS = "fid50k_full,kid50k_full,pr50k3_full"
TINY = dict(depth=2, hidden_size=64, patch_size=2)
MODEL = ["--model", "DiM-T/2", "--image-size", "64", "--num-classes", "5",
         "--block-type", "combined", "--bimamba-type", "none", "--rms-norm",
         "--cond-mamba", "--learnable-pe", "--use-attn-every-k-layers", "2",
         "--path-type", "GVP", "--device", "cpu"]


@pytest.fixture(autouse=True)
def tiny_zoo(monkeypatch):
    monkeypatch.setitem(DiM_models, "DiM-T/2",
                        lambda **kw: DiMConfig(**TINY, **kw))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval-cli")
    cfg = DiMConfig(**TINY, img_resolution=8, num_classes=5,
                    label_dropout=0.1, use_attn_every_k_layers=2)
    torch.save({"ema": random_init_(DiM(cfg), 1).state_dict()},
               root / "ckpt.pt")
    vae = random_init_vae_(AutoencoderKL(ch=32, ch_mult=(1, 1, 1, 1)), 2)
    torch.save(vae.state_dict(), root / "vae.pt")
    rng = np.random.default_rng(0)
    (root / "real").mkdir()
    for i in range(12):
        write_png(str(root / "real" / f"{i:03d}.png"),
                  rng.integers(0, 256, (64, 64, 3)).astype(np.uint8))
    return root


def _ddp(root, out, *extra):
    return sample_ddp.main([
        "ODE", *MODEL, "--ckpt", str(root / "ckpt.pt"), "--sampling-method",
        "euler", "--num-sampling-steps", "3", "--cfg-scale", "1.5",
        "--per-proc-batch-size", "4", "--num-fid-samples", "10",
        "--sample-dir", str(out), *extra])


def _eval(root):
    return ["--vae-ckpt", str(root / "vae.pt"), "--eval-refdir",
            str(root / "real"), "--eval-metric", METRICS]


def _values(results):
    return {k: v for r in results for k, v in r["results"].items()}


def _close(got, want):
    assert set(got) == set(want) and want
    np.testing.assert_allclose(got["fid50k_full"], want["fid50k_full"],
                               rtol=1e-7)
    for k in ("kid50k_full", "pr50k3_full_precision",
              "pr50k3_full_recall"):
        assert got[k] == want[k], k


def test_streaming_and_disk_routes_agree(files, tmp_path):
    stream = _ddp(files, tmp_path / "a" / "stream", *_eval(files),
                  "--eval-streaming", "--save-images")
    disk = _ddp(files, tmp_path / "b" / "disk", *_eval(files))
    assert stream["generated_batches"] == disk["generated_batches"] == 3
    _close(_values(stream["results"]), _values(disk["results"]))
    names = sorted(p.name for p in (tmp_path / "a" / "stream").glob("*.png"))
    assert names == [f"{i:06d}.png" for i in range(10)]
    for n in names:
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "a" / "stream" / n)),
            read_png(str(tmp_path / "b" / "disk" / n)))
    assert not list((tmp_path / "b" / "disk").glob("feat-chunks-*"))

    folder = calc_metrics.main([
        "--metrics", METRICS, "--real-dir", str(files / "real"),
        "--gen-dir", str(tmp_path / "a" / "stream"), "--image-size", "64",
        "--device", "cpu", "--cache-dir", str(tmp_path / "cache")])
    _close(_values(folder), _values(stream["results"]))


def test_streaming_resumes_from_its_chunks(files, tmp_path):
    out = tmp_path / "run" / "samples"
    args = (*_eval(files), "--eval-streaming")
    first = _ddp(files, out, *args)
    chunks = out / "feat-chunks-rank0"
    saved = {p.name: np.load(p) for p in chunks.glob("chunk*.npy")}
    assert sorted(saved) == [f"chunk{i:06d}.npy" for i in range(3)]
    assert not list(out.glob("*.png"))  # streaming alone writes no image

    again = _ddp(files, out, *args)
    assert again["generated_batches"] == 0
    assert _values(again["results"]) == _values(first["results"])

    (chunks / "chunk000001.npy").unlink()
    third = _ddp(files, out, *args)
    assert third["generated_batches"] == 1
    np.testing.assert_array_equal(np.load(chunks / "chunk000001.npy"),
                                  saved["chunk000001.npy"])
    assert _values(third["results"]) == _values(first["results"])
    lines = (out / "metric-fid50k_full.jsonl").read_text().splitlines()
    assert len(lines) == 3


def test_latents_route_and_refusals(files, tmp_path):
    rec = _ddp(files, tmp_path / "lat")
    lat = np.load(rec["latents_path"])["latents"]
    assert lat.shape == (10, 4, 8, 8) and np.isfinite(lat).all()
    # --tp runs since it was ported; one process cannot hold two ranks
    with pytest.raises(ValueError, match="does not divide 1 processes"):
        _ddp(files, tmp_path / "tp", "--tp", "2")


def _train_argv(root, datadir, *extra):
    return ["--exp", "run", "--datadir", str(datadir), "--results-dir",
            str(root / "results"), *MODEL[:-2], "--global-batch-size",
            "4", "--log-every", "2", "--num-workers", "1", "--device",
            "cpu", "--epochs", "1", "--plot-every", "100", "--ckpt-every",
            "100", "--save-content-every", "100", *extra]


def _fit(argv):
    trainer = train_cli.Trainer(train_cli.parse_args(argv))
    try:
        trainer.fit()
    finally:
        trainer.close()
    return trainer


def test_train_in_training_fid(files, tmp_path):
    rng = np.random.default_rng(1)
    rng.standard_normal((8, 4, 8, 8)).astype(np.float32).tofile(
        tmp_path / "latents.dat")
    rng.integers(0, 4, 8).astype(np.int64).tofile(tmp_path / "labels.dat")
    _fit(_train_argv(tmp_path, tmp_path, "--dataset", "latent_memmap",
                     "--vae-ckpt", str(files / "vae.pt"), "--eval-refdir",
                     str(files / "real"), "--eval-every", "1",
                     "--eval-nsamples", "6", "--eval-bs", "3"))
    run = tmp_path / "results" / "run"
    lines = (run / "metric-fid2k_full.jsonl").read_text().splitlines()
    assert len(lines) == 1  # epoch 1 (none at epoch 0)
    assert np.isfinite(json.loads(lines[0])["results"]["fid2k_full"])
    assert list((run / "stats-cache").glob("real-stats-*.npz"))
    with pytest.raises(SystemExit, match="needs --vae-ckpt"):
        train_cli.Trainer(train_cli.parse_args(_train_argv(
            tmp_path, tmp_path, "--dataset", "latent_memmap",
            "--eval-refdir", str(files / "real"))))


def test_train_from_an_image_folder(files, tmp_path):
    trainer = _fit(_train_argv(tmp_path, files / "real", "--dataset",
                               "image_folder", "--vae-ckpt",
                               str(files / "vae.pt"), "--log-every", "1"))
    assert trainer.train_steps == 6  # 12 images, batch 4, epochs 0-1
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    with pytest.raises(SystemExit, match="in pixels"):
        train_cli.Trainer(train_cli.parse_args(_train_argv(
            tmp_path, files / "real", "--dataset", "image_folder")))


def test_extract_real_samples(files, tmp_path):
    out = extract_real_samples.main([
        "--dataset", "image_folder", "--datadir", str(files / "real"),
        "--save_dir", str(tmp_path), "--image_size", "32",
        "--max_images", "5"])
    ds = ImageFolderDataset(str(files / "real"), 32, raw_uint8=True)
    for i in range(5):
        np.testing.assert_array_equal(read_png(f"{out}/{i}.png"),
                                      ds[i][0].transpose(1, 2, 0))
    assert not (tmp_path / "image_folder" / "5.png").exists()
    with pytest.raises(SystemExit, match="latent"):
        extract_real_samples.main(["--dataset", "latent_memmap"])


def test_make_synthetic_latents_equals_jax_tool(tmp_path, monkeypatch):
    common = ["--n", "6", "--classes", "3", "--image-size", "64"]
    make_synthetic_latents.main(["--out", str(tmp_path / "port"), *common,
                                 "--decode-real", "random:1", "--n-real",
                                 "2", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["make_synthetic_latents.py", "--out",
                                      str(tmp_path / "jax"), *common])
    runpy.run_path("tools/make_synthetic_latents.py", run_name="__main__")
    for name in ("latents.dat", "labels.dat"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    pngs = sorted((tmp_path / "port" / "real_png").glob("*.png"))
    assert [p.name for p in pngs] == ["000000.png", "000001.png"]
    assert read_png(str(pngs[0])).shape == (64, 64, 3)
