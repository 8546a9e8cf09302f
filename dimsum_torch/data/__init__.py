"""Input pipelines of the port, from `dimsum_tpu/data`: the latent and
pixel datasets, the threaded loader and the copy to the card.

`get_dataset` dispatches on `--dataset` as the JAX one does (the
reference's datasets_prep/__init__.py:10-135).
"""

from __future__ import annotations

import os

from dimsum_torch.data.datasets import (  # noqa: F401
    Dataset,
    ImageFolderDataset,
    LMDBDataset,
    LatentFolderDataset,
    LatentMemmapDataset,
    center_crop_arr,
)
from dimsum_torch.data.loader import Loader, device_batches  # noqa: F401
from dimsum_torch.data.native import NativeLatentStore  # noqa: F401

LMDB_DATASETS = ("celeba_256", "celeba_512", "lsun_church")
FOLDER_DATASETS = ("imagenet", "ffhq", "image_folder", "cifar10")


def get_dataset(args):
    """The dataset `args.dataset` names, from `args.datadir`:

      * latent_memmap, latent_memmap_imagenet: `latents.dat` (fp32, rows
        of (num_in_channels, image_size / 8, image_size / 8)) and
        `labels.dat` (int64) if present, the layout `preprocess.py`
        writes;
      * latent_<anything else>: `features/` and, if present, `labels/`,
        one `.npy` a sample;
      * celeba_256, celeba_512, lsun_church: an LMDB of images;
      * imagenet (labels from the class folders), ffhq, image_folder,
        cifar10: a folder or `.zip` of images.

    The pixel datasets give images in [-1, 1] at image_size; an unknown
    name raises `ValueError`."""
    name = args.dataset
    datadir = args.datadir
    if name in ("latent_memmap_imagenet", "latent_memmap"):
        labels = os.path.join(datadir, "labels.dat")
        latent = getattr(args, "image_size", 256) // 8
        return LatentMemmapDataset(
            os.path.join(datadir, "latents.dat"),
            labels if os.path.exists(labels) else None,
            latent_shape=(getattr(args, "num_in_channels", 4), latent,
                          latent))
    if name.startswith("latent_"):
        labels_dir = os.path.join(datadir, "labels")
        return LatentFolderDataset(
            os.path.join(datadir, "features"),
            labels_dir if os.path.isdir(labels_dir) else None)
    image_size = getattr(args, "image_size", 256)
    if name in LMDB_DATASETS:
        return LMDBDataset(datadir, name, image_size=image_size)
    if name in FOLDER_DATASETS:
        return ImageFolderDataset(datadir, image_size=image_size,
                                  use_labels=(name == "imagenet"))
    raise ValueError(f"unknown dataset {name}")
