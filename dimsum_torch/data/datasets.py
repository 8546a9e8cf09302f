"""Latent datasets, port of `dimsum_tpu/data/datasets.py` (:34-107): one
fp32 memmap of precomputed VAE latents, or one `.npy` file a sample.  Both
return numpy arrays, as the JAX ones do; `data.loader.Loader` assembles
the batches and copies them to the card.

The pixel datasets (`ImageFolderDataset`, `LMDBDataset`,
`center_crop_arr`) need PIL or lmdb and wait for ROADMAP.md Queue 1 item 6
with the VAE encode (`data.get_dataset` raises for them).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from dimsum_torch.data.native import NativeLatentStore


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
