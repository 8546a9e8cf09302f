"""The port's pixel data (`dimsum_torch/data/datasets.py`,
`utils/png.py`) and `python -m dimsum_torch.preprocess`:

  * the standard-library PNG reader equals PIL's decode on PNGs PIL writes
    (grey, grey + alpha, RGB, RGBA) and on PNGs whose rows use each of the
    five filter types;
  * ImageFolderDataset equals the JAX one item for item: a directory (PNGs
    at the training size, which skip resampling, and larger PNGs and a
    JPEG, which go through PIL), subfolder labels, a dataset.json manifest,
    xflip, raw uint8, and a .zip archive;
  * get_dataset routes the pixel names; LMDBDataset reads a stub `lmdb`
    module (as tests/test_data_eval.py does) like the JAX one;
  * without PIL, a file that needs it raises an error naming the file;
  * preprocess writes the (2N, 4, S/8, S/8) latent memmap (the images,
    then their flips, each the VAE's posterior draw with the generator's
    noise) and its labels, and a rerun resumes: written batches are
    skipped, a missing one is encoded again with the same draws.
"""

import argparse
import io
import json
import struct
import sys
import types
import zipfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import dimsum_torch.data.datasets as port
import dimsum_tpu.data.datasets as ref
from dimsum_torch import preprocess
from dimsum_torch.data import get_dataset
from dimsum_torch.models.vae import AutoencoderKL, random_init_vae_
from dimsum_torch.utils.png import decode_png, read_png
from tests.test_torch_convert import torch_one_thread  # noqa: F401


def _rgb(seed, h, w):
    """A smooth image with noise, so that PIL's encoder mixes filters."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 3 + y, y * 2, (x * y) % 200], -1)
    return (base + rng.integers(0, 30, (h, w, 3))).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_equals_pil_on_pil_files(mode):
    rgb = _rgb(0, 37, 41)
    arr = {"L": rgb[..., 0], "LA": rgb[..., :2], "RGB": rgb,
           "RGBA": np.concatenate([rgb, rgb[..., :1]], -1)}[mode]
    for opts in ({}, {"optimize": True}, {"compress_level": 1}):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG", **opts)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        got = decode_png(buf.getvalue())
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """An RGB PNG whose row r uses filter kinds[r % len(kinds)] (the PNG
    spec's forward filters)."""
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for r in range(h):
        k = kinds[r % len(kinds)]
        prev = raw[r - 1] if r else np.zeros(w * ch, np.int64)
        row = []
        for i in range(w * ch):
            a = raw[r, i - ch] if i >= ch else 0
            b = prev[i]
            c = prev[i - ch] if i >= ch else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[k]
            row.append((raw[r, i] - pred) % 256)
        out.append(bytes([k] + row))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_each_filter_type(kind, tmp_path):
    img = _rgb(1, 9, 11)
    data = _filtered_png(img, [kind])
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(decode_png(data), img)
    (tmp_path / "mixed.png").write_bytes(_filtered_png(img, [3, 4, 1, 2, 0]))
    np.testing.assert_array_equal(read_png(str(tmp_path / "mixed.png")), img)


def test_png_reader_refuses_what_it_cannot_read():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16) + 300).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(buf.getvalue(), "deep.png")
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a", "a.gif")


S = 16  # the training size of the folder tests


@pytest.fixture
def folder(tmp_path):
    root = tmp_path / "images"
    for cls, seeds in (("cat", (0, 1, 2)), ("dog", (3, 4))):
        (root / cls).mkdir(parents=True)
        for s in seeds:
            size = (S, S) if s % 2 == 0 else (24 + s, 20 + 3 * s)
            Image.fromarray(_rgb(s, *size)).save(root / cls / f"{s}.png")
    Image.fromarray(_rgb(9, 30, 40)).save(root / "dog" / "9.jpg",
                                          quality=90)
    Image.fromarray(_rgb(10, S, S)[..., 0], "L").save(root / "cat" / "g.png")
    return root


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        (x, y), (xw, yw) = got[i], want[i]
        assert y == yw and x.dtype == xw.dtype, i
        np.testing.assert_array_equal(x, xw, err_msg=str(i))


@pytest.mark.parametrize("kw", [
    dict(), dict(use_labels=True), dict(xflip=True),
    dict(raw_uint8=True, xflip=True, use_labels=True)])
def test_image_folder_equals_jax(folder, kw):
    _same_items(port.ImageFolderDataset(str(folder), S, **kw),
                ref.ImageFolderDataset(str(folder), S, **kw))
    assert port.ImageFolderDataset(str(folder), S, **kw).labels == \
        ref.ImageFolderDataset(str(folder), S, **kw).labels


def test_image_folder_manifest_and_zip(folder, tmp_path):
    names = sorted(p.relative_to(folder).as_posix()
                   for p in folder.rglob("*") if p.is_file())
    (folder / "dataset.json").write_text(json.dumps(
        {"labels": [[n, i * 3] for i, n in enumerate(names)]}))
    _same_items(port.ImageFolderDataset(str(folder), S),
                ref.ImageFolderDataset(str(folder), S))
    assert port.ImageFolderDataset(str(folder), S).labels[0] == 0
    archive = tmp_path / "images.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        for p in folder.rglob("*"):
            if p.is_file():
                zf.write(p, p.relative_to(folder).as_posix())
    got = port.ImageFolderDataset(str(archive), S, xflip=True)
    _same_items(got, ref.ImageFolderDataset(str(archive), S, xflip=True))
    assert got.labels == [i * 3 for i in range(len(names))]


def test_get_dataset_serves_pixels(folder, tmp_path, monkeypatch):
    args = argparse.Namespace(dataset="imagenet", datadir=str(folder),
                              image_size=S)
    ds = get_dataset(args)
    assert isinstance(ds, port.ImageFolderDataset) and len(ds) == 7
    assert ds[0][0].shape == (3, S, S) and ds.labels == [0] * 4 + [1] * 3
    for name in ("image_folder", "ffhq", "cifar10"):
        args.dataset = name
        assert get_dataset(args).labels is None

    store = {}
    for i in range(3):
        buf = io.BytesIO()
        Image.fromarray(_rgb(i, 40, 48)).save(buf, format="PNG")
        store[str(i).encode()] = buf.getvalue()

    class Txn:
        def get(self, key):
            return store[key]

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Env:
        def begin(self, write=False):
            assert not write
            return Txn()

    opened = []
    stub = types.ModuleType("lmdb")
    stub.open = lambda path, **kw: opened.append(path) or Env()
    monkeypatch.setitem(sys.modules, "lmdb", stub)
    ds = get_dataset(argparse.Namespace(dataset="celeba_256",
                                        datadir=str(tmp_path),
                                        image_size=32))
    assert isinstance(ds, port.LMDBDataset) and len(ds) == 30000
    assert opened[0].endswith("train.lmdb")
    _same_items([ds[i] for i in range(3)],
                [ref.LMDBDataset(str(tmp_path), "celeba_256", 32)[i]
                 for i in range(3)])


def test_without_pil_the_error_names_the_file(folder, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = port.ImageFolderDataset(str(folder), S)
    names = [f.rsplit("/", 1)[-1] for f in ds.files]
    assert ds[names.index("0.png")][0].shape == (3, S, S)  # no PIL needed
    with pytest.raises(ImportError, match="1.png.*needs PIL"):
        ds[names.index("1.png")]
    with pytest.raises(ImportError, match="9.jpg"):
        ds[names.index("9.jpg")]


def test_preprocess_layout_and_resume(folder, tmp_path):
    vae = random_init_vae_(AutoencoderKL(ch=32, ch_mult=(1, 1, 1, 1)), 2)
    torch.save(vae.state_dict(), tmp_path / "vae.pt")
    out = tmp_path / "latents"
    argv = ["--datadir", str(folder), "--outdir", str(out), "--image-size",
            str(S), "--vae-ckpt", str(tmp_path / "vae.pt"), "--use-labels",
            "--batch-size", "3", "--seed", "4", "--device", "cpu"]
    rec = preprocess.main(argv)
    assert rec["encoded"] == 3 and rec["skipped"] == 0
    n, lat = 7, S // 8
    feats = np.fromfile(out / "latents.dat", np.float32).reshape(
        2 * n, 4, lat, lat)
    labels = np.fromfile(out / "labels.dat", np.int64)
    ds = port.ImageFolderDataset(str(folder), S, use_labels=True)
    np.testing.assert_array_equal(labels, np.tile(ds.labels, 2))

    # the same draws: one generator, noise for the images, then the flips
    g = torch.Generator().manual_seed(4)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(7)]))
    want, want_flip = [], []
    for i in range(0, n, 3):
        j = min(i + 3, n)
        a, b = (torch.randn((j - i, 4, lat, lat), generator=g)
                for _ in range(2))
        with torch.no_grad():
            want.append(vae.encode(x[i:j], noise=a))
            want_flip.append(vae.encode(x[i:j].flip(-1), noise=b))
    np.testing.assert_allclose(feats[:n], torch.cat(want).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feats[n:], torch.cat(want_flip).numpy(),
                               rtol=1e-5, atol=1e-6)

    assert preprocess.main(argv)["encoded"] == 0
    done = feats.copy()
    m = np.memmap(out / "latents.dat", np.float32, "r+",
                  shape=feats.shape)
    m[n + 3:n + 6] = 0
    m.flush()
    del m
    rec = preprocess.main(argv)
    assert rec["encoded"] == 1 and rec["skipped"] == 2
    np.testing.assert_array_equal(
        np.fromfile(out / "latents.dat", np.float32).reshape(feats.shape),
        done)
