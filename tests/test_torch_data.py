"""The port's input pipeline (`dimsum_torch/data`) against the JAX
package's (`dimsum_tpu/data`) on the same files: a latent memmap of 37
seeded fp32 rows (4 x 8 x 8) with int64 labels, and a folder of 37 `.npy`
latents with label files.

  * the datasets and `Loader` give the JAX ones' batches bit for bit
    (tolerance 0): two epochs, shards 0 and 1 of 2 and the whole, with and
    without drop_last, through `gather` (memmap) and item by item (folder);
  * the native gather (C++ threads, built with g++ from the port's own
    source into build/dimsum_torch/) equals the numpy route and the memmap
    itself; the default route is the native one; a build that fails raises
    instead of falling back; an index outside the file raises;
  * a worker's exception reaches the consumer; 32 workers under a 10-us
    switch interval deliver every batch once, in order; `device_batches`
    hands the batches over as tensors unchanged;
  * `get_dataset` takes the latent routes; its pixel routes look for
    images (or the lmdb package) where they are asked to.
"""

import argparse

import numpy as np
import pytest
import torch

import dimsum_torch.data.native as native
from dimsum_tpu.data import LatentFolderDataset as JaxFolder
from dimsum_tpu.data import LatentMemmapDataset as JaxMemmap
from dimsum_tpu.data import Loader as JaxLoader
from dimsum_torch.data import (LatentFolderDataset, LatentMemmapDataset,
                               Loader, NativeLatentStore, device_batches,
                               get_dataset)
from tests.test_torch_convert import torch_one_thread  # noqa: F401

N, SHAPE = 37, (4, 8, 8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """latents.dat / labels.dat and features/ / labels/ of the same rows."""
    root = tmp_path_factory.mktemp("latents")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, *SHAPE)).astype(np.float32)
    y = rng.integers(0, 1000, N).astype(np.int64)
    x.tofile(root / "latents.dat")
    y.tofile(root / "labels.dat")
    (root / "features").mkdir()
    (root / "labels").mkdir()
    for i in range(N):
        np.save(root / "features" / f"{i:09d}.npy", x[i])
        np.save(root / "labels" / f"{i:09d}.npy", y[i])
    return root, x, y


def _batches(loader):
    return [(np.array(x), np.array(y)) for x, y in loader]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shard,shards", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("kind", ["memmap", "folder"])
def test_loader_batches_equal_jax(files, kind, shard, shards, drop_last):
    root, _, _ = files
    if kind == "memmap":
        ours = LatentMemmapDataset(str(root / "latents.dat"),
                                   str(root / "labels.dat"),
                                   latent_shape=SHAPE)
        theirs = JaxMemmap(str(root / "latents.dat"),
                           str(root / "labels.dat"), latent_shape=SHAPE)
    else:
        ours = LatentFolderDataset(str(root / "features"),
                                   str(root / "labels"))
        theirs = JaxFolder(str(root / "features"), str(root / "labels"))
    kw = dict(batch_size=5, seed=3, drop_last=drop_last, shard_id=shard,
              num_shards=shards, num_workers=3)
    port, jax_loader = Loader(ours, **kw), JaxLoader(theirs, **kw)
    assert len(port) == len(jax_loader)
    seen = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got, want = _batches(port), _batches(jax_loader)
        assert len(got) == len(want) == len(port)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
        seen.append(np.concatenate([gy for _, gy in got]))
    assert not np.array_equal(seen[0], seen[1])  # the epochs reshuffle


def test_native_gather_equals_numpy(files):
    root, x, y = files
    ds = LatentMemmapDataset(str(root / "latents.dat"),
                             str(root / "labels.dat"), latent_shape=SHAPE)
    plain = LatentMemmapDataset(str(root / "latents.dat"),
                                str(root / "labels.dat"),
                                latent_shape=SHAPE, use_native=False)
    assert ds.is_native and not plain.is_native
    idx = np.random.default_rng(1).permutation(N)[:23]
    gx, gy = ds.gather(idx)
    px, py = plain.gather(idx)
    np.testing.assert_array_equal(gx, px)
    np.testing.assert_array_equal(gx, x[idx])
    np.testing.assert_array_equal(gy, y[idx])
    np.testing.assert_array_equal(py, y[idx])
    # a batch over the 8-MB thread fan-out
    store = NativeLatentStore(str(root / "latents.dat"), SHAPE)
    big = np.tile(idx, 600)
    np.testing.assert_array_equal(store.gather(big), x[big])
    with pytest.raises(IndexError):
        store.gather([0, N])
    with pytest.raises(IndexError):
        ds.gather([N])
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.gather([0])


def test_failed_native_build_raises(files, tmp_path, monkeypatch):
    root, _, _ = files
    bad = tmp_path / "batch_gather.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            LatentMemmapDataset(str(root / "latents.dat"),
                                latent_shape=SHAPE)
        # the numpy route is there when asked for
        ds = LatentMemmapDataset(str(root / "latents.dat"),
                                 latent_shape=SHAPE, use_native=False)
        assert not ds.is_native and ds.gather([1])[1].tolist() == [0]
    finally:
        native.load.cache_clear()


def test_library_is_keyed_by_source(tmp_path, monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    src = tmp_path / "batch_gather.cpp"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != path


class _Failing:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 7:
            raise KeyError("row 7 is unreadable")
        return np.zeros(2, np.float32), i


def test_worker_exception_reaches_the_consumer():
    loader = Loader(_Failing(), batch_size=2, shuffle=False, num_workers=2)
    with pytest.raises(KeyError, match="row 7"):
        _batches(loader)


def test_device_batches_hand_over_tensors(files):
    root, x, y = files
    ds = LatentMemmapDataset(str(root / "latents.dat"),
                             str(root / "labels.dat"), latent_shape=SHAPE)
    loader = Loader(ds, batch_size=8, shuffle=False)
    got = list(device_batches(loader, "cpu"))
    assert len(got) == 4
    for i, (bx, by) in enumerate(got):
        assert bx.dtype == torch.float32 and by.dtype == torch.int64
        np.testing.assert_array_equal(bx.numpy(), x[8 * i:8 * i + 8])
        np.testing.assert_array_equal(by.numpy(), y[8 * i:8 * i + 8])


def test_get_dataset_routes(files):
    root, x, _ = files

    def args(name):
        return argparse.Namespace(dataset=name, datadir=str(root),
                                  image_size=64, num_in_channels=4)

    ds = get_dataset(args("latent_memmap_imagenet"))
    assert isinstance(ds, LatentMemmapDataset) and len(ds) == N
    np.testing.assert_array_equal(ds[5][0], x[5])
    ds = get_dataset(args("latent_imagenet"))
    assert isinstance(ds, LatentFolderDataset) and len(ds) == N
    # the pixel routes (tests/test_torch_eval_data.py): an image folder
    # finds no image among the latents, an LMDB needs the lmdb package
    for name in ("imagenet", "cifar10"):
        with pytest.raises(FileNotFoundError, match="no images"):
            get_dataset(args(name))
    for name in ("celeba_256", "lsun_church"):
        with pytest.raises(ImportError, match="lmdb"):
            get_dataset(args(name))
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset(args("mnist"))


class _Items:
    """A dataset read item by item, its sample the index itself."""

    def __len__(self):
        return 200

    def __getitem__(self, i):
        return np.full(2, i, np.float32), i


def test_loader_under_thread_stress():
    """32 worker threads (more than the cores) with a 10-us switch interval,
    prefetch 1, over three epochs: every batch arrives once and in order,
    the labels those of the epoch's shuffled stripe; the run is bounded by
    a 60-s timeout (a lost slot or a lost result would hang or drop a
    batch)."""
    import sys
    import threading

    loader = Loader(_Items(), batch_size=3, seed=5, drop_last=False,
                    num_workers=32, prefetch=1)
    got, want = [], []

    def consume():
        for epoch in range(3):
            loader.set_epoch(epoch)
            want.append(loader._epoch_indices())
            got.append(np.concatenate([y for _, y in loader]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "the loader hung"
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
