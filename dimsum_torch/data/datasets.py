"""Datasets, port of `dimsum_tpu/data/datasets.py`: one fp32 memmap of
precomputed VAE latents, one `.npy` latent a sample, a folder (or `.zip`)
of images, an LMDB of images.  All return numpy arrays, as the JAX ones
do; `data.loader.Loader` assembles the batches and copies them to the
card.

The card's machine has no PIL and no lmdb.  So `.png` files are decoded by
the standard-library reader of `utils/png.py`, and an image already at the
wanted size is cropped without resampling (PIL's resize to the same size is
a copy, so this is exact).  PIL is imported only to decode other formats
or to resample, and where it is missing the error names the file.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from dimsum_torch.data.native import NativeLatentStore
from dimsum_torch.utils.png import decode_png


class Dataset:
    """Map-style dataset protocol: __len__ and __getitem__ -> (sample
    ndarray, label int)."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class LatentMemmapDataset(Dataset):
    """One memmap of precomputed VAE latents, (N, 4, 32, 32) fp32 at 256 px
    (the reference's latent_datasets.py:31-51: the originals and their
    horizontal flips), with an optional int64 label memmap of N rows.

    `gather(indices)` assembles a whole batch; with `use_native` (the
    default) through the C++ threads of `NativeLatentStore`, which raises
    if its library cannot be built, otherwise by numpy indexing.
    `is_native` says which."""

    def __init__(self, features_path: str, labels_path: Optional[str] = None,
                 num_samples: Optional[int] = None,
                 latent_shape: Tuple[int, int, int] = (4, 32, 32),
                 use_native: bool = True):
        if num_samples is None:  # from the file's size
            item_bytes = 4 * int(np.prod(latent_shape))
            num_samples = os.path.getsize(features_path) // item_bytes
        self.features = np.memmap(features_path, dtype=np.float32, mode="r",
                                  shape=(num_samples, *latent_shape))
        self.store = NativeLatentStore(features_path, latent_shape,
                                       native=use_native)
        self.labels = None
        if labels_path:
            self.labels = np.memmap(labels_path, dtype=np.int64, mode="r",
                                    shape=(num_samples,))
        self.num_samples = num_samples

    @property
    def is_native(self) -> bool:
        return self.store.is_native

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        x = np.asarray(self.features[idx], np.float32)
        y = int(self.labels[idx]) if self.labels is not None else 0
        return x, y

    def gather(self, indices):
        """(xs (n, *latent_shape) fp32, ys (n,) int64) for `indices`."""
        idx = np.asarray(indices)
        if len(idx) and (idx.min() < 0 or idx.max() >= self.num_samples):
            raise IndexError(f"indices outside [0, {self.num_samples})")
        xs = self.store.gather(idx)
        if self.labels is not None:
            ys = np.asarray(self.labels[idx], np.int64)
        else:
            ys = np.zeros(len(idx), np.int64)
        return xs, ys


class LatentFolderDataset(Dataset):
    """One `.npy` latent a sample, named 000000000.npy, ..., and optionally
    one label `.npy` each under the same names (the reference's
    latent_datasets.py:54-73)."""

    def __init__(self, features_dir: str, labels_dir: Optional[str] = None,
                 num_samples: Optional[int] = None):
        self.features_dir = features_dir
        self.labels_dir = labels_dir
        if num_samples is None:
            num_samples = len([f for f in os.listdir(features_dir)
                               if f.endswith(".npy")])
        self.num_samples = num_samples

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        fid = f"{str(idx).zfill(9)}.npy"
        x = np.load(os.path.join(self.features_dir, fid)).astype(np.float32)
        if self.labels_dir is not None:
            y = int(np.load(os.path.join(self.labels_dir, fid)))
        else:
            y = 0
        return x, y


def _pil(name: str):
    """PIL's Image module, or an ImportError naming the file that needs
    it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{name}: decoding this image or resampling it needs PIL, which "
            "is not installed; give PNG files at the training size") from e
    return Image


def decode_image(data: bytes, name: str) -> np.ndarray:
    """An image file's bytes -> (H, W, 3) uint8 RGB: PNG by
    `utils/png.py` (grey replicated, alpha dropped, as PIL's
    convert("RGB") does), any other format by PIL."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = decode_png(data, name)
        if img.shape[2] in (1, 2):
            return np.repeat(img[:, :, :1], 3, axis=2)
        return np.ascontiguousarray(img[:, :, :3])
    from io import BytesIO

    with _pil(name).open(BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def center_crop_arr(image, image_size: int, name: str = "<image>"):
    """ADM's center crop (the reference's data_transforms.py): halve by
    box filters while the short side is >= 2 * image_size, resize bicubic
    to image_size on the short side, crop the center.  `image` is a PIL
    image or an (H, W, 3) uint8 array; an array whose short side is
    already image_size is only cropped (every resize would be to the same
    size, a copy), others go through PIL."""
    if isinstance(image, np.ndarray):
        if min(image.shape[:2]) == image_size:
            arr = image
        else:
            return center_crop_arr(_pil(name).fromarray(image), image_size)
    else:
        Image = _pil(name)
        pil_image = image
        while min(*pil_image.size) >= 2 * image_size:
            pil_image = pil_image.resize(
                tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
        scale = image_size / min(*pil_image.size)
        pil_image = pil_image.resize(
            tuple(round(x * scale) for x in pil_image.size),
            resample=Image.BICUBIC)
        arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y: crop_y + image_size, crop_x: crop_x + image_size]


class ImageFolderDataset(Dataset):
    """Images from a directory tree or a `.zip` archive (the eval toolbox's
    two source kinds, the reference's training/dataset.py:150-199).

    Labels come from a `dataset.json` manifest when present
    ({"labels": [[relative_fname, int], ...]}, the StyleGAN-ADA
    convention), else from the sorted first-level subfolder names when
    `use_labels`.  Items are CHW float32 in [-1, 1], or CHW uint8 with
    `raw_uint8`; `xflip` appends the horizontal flips (the eval toolbox's
    doubling)."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

    def __init__(self, root: str, image_size: int = 256,
                 use_labels: bool = False, xflip: bool = False,
                 raw_uint8: bool = False):
        import json

        self.root = root
        self.image_size = image_size
        self.xflip = xflip
        self.raw_uint8 = raw_uint8
        self._is_zip = os.path.isfile(root) and root.lower().endswith(".zip")
        self._zf = None
        manifest = None
        if self._is_zip:
            import zipfile

            with zipfile.ZipFile(root) as zf:
                names = sorted(zf.namelist())
                if "dataset.json" in names:
                    manifest = json.loads(zf.read("dataset.json"))["labels"]
            files = [n for n in names if n.lower().endswith(self.EXTS)]
        else:
            mpath = os.path.join(root, "dataset.json")
            if os.path.isfile(mpath):
                with open(mpath) as f:
                    manifest = json.load(f)["labels"]
            files = []
            for dirpath, _, names in sorted(os.walk(root)):
                for n in sorted(names):
                    if n.lower().endswith(self.EXTS):
                        files.append(os.path.join(dirpath, n))
        if not files:
            raise FileNotFoundError(f"no images under {root}")
        self.files = files
        self.labels = None
        if manifest is not None:
            lut = {k.replace("\\", "/"): int(v) for k, v in manifest}

            def rel(f):
                return (f if self._is_zip
                        else os.path.relpath(f, root)).replace(os.sep, "/")

            self.labels = [lut.get(rel(f), 0) for f in files]
        elif use_labels and not self._is_zip:
            def top(f):
                return os.path.relpath(f, root).split(os.sep)[0]

            classes = sorted({top(f) for f in files})
            cls_idx = {c: i for i, c in enumerate(classes)}
            self.labels = [cls_idx[top(f)] for f in files]

    def _read(self, fname) -> bytes:
        if self._is_zip:
            import zipfile

            if self._zf is None:  # opened lazily, once a process
                self._zf = zipfile.ZipFile(self.root)
            return self._zf.read(fname)
        with open(fname, "rb") as f:
            return f.read()

    def __getstate__(self):  # a zip handle does not pickle
        d = dict(self.__dict__)
        d["_zf"] = None
        return d

    def __len__(self):
        return len(self.files) * (2 if self.xflip else 1)

    def __getitem__(self, idx):
        base = len(self.files)
        flip = idx >= base
        fidx = idx - base if flip else idx
        name = self.files[fidx]
        arr = center_crop_arr(decode_image(self._read(name), name),
                              self.image_size, name)
        if flip:
            arr = arr[:, ::-1]
        y = self.labels[fidx] if self.labels is not None else 0
        if self.raw_uint8:
            return np.ascontiguousarray(arr.transpose(2, 0, 1)), y
        x = arr.astype(np.float32) / 127.5 - 1.0
        return np.ascontiguousarray(x.transpose(2, 0, 1)), y


class LMDBDataset(Dataset):
    """NVAE-style LMDB of encoded images under str(index) keys (the
    reference's lmdb_datasets.py).  Needs the `lmdb` package, imported
    when the dataset is made."""

    SIZES = {"celeba_256": 30000, "celeba_512": 30000,
             "lsun_church": 126227}

    def __init__(self, root: str, name: str, image_size: int = 256,
                 train: bool = True):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                f"{root}: LMDBDataset needs the 'lmdb' package, which is "
                "not installed") from e
        path = os.path.join(root, "train.lmdb" if train else
                            "validation.lmdb")
        self.env = lmdb.open(path, readonly=True, lock=False)
        self.image_size = image_size
        self.num = self.SIZES.get(name, 0)

    def __len__(self):
        return self.num

    def __getitem__(self, idx):
        with self.env.begin(write=False) as txn:
            data = txn.get(str(idx).encode())
        name = f"lmdb key {idx}"
        arr = center_crop_arr(decode_image(data, name), self.image_size,
                              name).astype(np.float32)
        x = arr / 127.5 - 1.0
        return np.ascontiguousarray(x.transpose(2, 0, 1)), 0
