"""Feature detectors of the metric suite, port of
`dimsum_tpu/eval/features.py`.

The reference loads TorchScript detectors by URL (Inception-2015-12-05 for
FID, VGG16 for LPIPS); here every detector is a local file or a seeded
stand-in, chosen by the JAX CLIs' spec strings (`make_detector`):

  None, "randproj"      RandomProjectionDetector: numpy, weight-less, the
                        JAX one bit for bit (smoke runs and tests);
  "jax-random", "inception-random"
                        the port's InceptionV3 (eval/inception.py) with
                        seeded He-scaled weights, on the device: the real
                        FID network without a weights file (relative
                        trends; its draws are not flax's, so its cache id
                        is "torch-random-he", never "jax-random-he");
  "jax:<pth>", "inception:<pth>"
                        the port's InceptionV3 with a local torchvision /
                        pytorch-fid state dict, on the device;
  "<path.pt>"           a TorchScript detector file (the reference's own
                        inception-2015-12-05.pt), on the device.

Every detector maps uint8 NCHW images, a numpy array or a uint8 tensor, to
(N, F) float32 numpy features.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dimsum_torch.eval.fid import FeatureStats, no_tf32
from dimsum_torch.eval.inception import InceptionDetector
from dimsum_torch.utils.device import resolve_device


def _as_numpy(images) -> np.ndarray:
    if isinstance(images, torch.Tensor):
        return images.cpu().numpy()
    return np.asarray(images)


class TorchScriptDetector:
    """A TorchScript detector file (the `.pt` the reference downloads), run
    on `device` with TF32 off.  Input: uint8 NCHW images, not resized here
    (the reference's metric_utils.py:272-277 feeds raw uint8)."""

    def __init__(self, path: str, device="cuda", **detector_kwargs):
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"detector weights not found at {path}; copy "
                "inception-2015-12-05.pt / vgg16.pt from a networked machine")
        self.device = torch.device(device)
        self.model = torch.jit.load(path, map_location=self.device).eval()
        self.kwargs = detector_kwargs

    def __call__(self, images) -> np.ndarray:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        with torch.no_grad(), no_tf32():
            out = self.model(images.to(self.device), **self.kwargs)
        return out.float().cpu().numpy()


class RandomProjectionDetector:
    """Deterministic stand-in detector for tests and smoke runs without
    detector weights: global-average-pool moments and a fixed random
    projection, in numpy (the JAX one, bit for bit)."""

    def __init__(self, num_features: int = 64, seed: int = 0):
        self.num_features = num_features
        self.seed = seed
        self._w = None

    def __call__(self, images_uint8) -> np.ndarray:
        x = _as_numpy(images_uint8).astype(np.float32) / 255.0
        B, C, H, W = x.shape
        pooled = x.reshape(B, C, -1)
        moments = np.concatenate(
            [pooled.mean(-1), pooled.std(-1),
             np.abs(np.fft.rfft(pooled.mean(1), axis=-1))[:, :13]], axis=1)
        if self._w is None:
            rng = np.random.default_rng(self.seed)
            self._w = rng.standard_normal(
                (moments.shape[1], self.num_features)).astype(np.float32)
        return moments @ self._w


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's "SAME" padding for a k x k kernel at stride s (the extra pixel
    of an odd total after)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RandomLPIPS:
    """Random-He conv stack standing in for the reference's vgg16.pt LPIPS
    detector (perceptual_path_length.py:99: float NCHW images in [0, 255]
    -> (N, F) embeddings whose squared-difference sum is the perceptual
    distance): convs 5x5/4, 3x3/2, 3x3/2 with ReLU and "SAME" padding,
    mean and max pooled, then a projection.  The weights (variance
    2 / fan_in) come from a seeded CPU generator when the first images
    give the channel count; `weights` holds them (conv weights OIHW, the
    projection (256, F)).  For exercising PPL without weights files; the
    real vgg16.pt gives reference-comparable numbers.  It runs on the card
    unless `device` asks for the CPU."""

    LAYERS = ((5, 32, 4), (3, 64, 2), (3, 128, 2))  # kernel, out, stride

    def __init__(self, num_features: int = 128, seed: int = 0,
                 device="cuda"):
        self.num_features = num_features
        self.seed = seed
        self.device = resolve_device(device)
        self.weights = None

    def _build(self, channels: int):
        g = torch.Generator().manual_seed(self.seed)
        ws, cin = [], channels
        for k, cout, _ in self.LAYERS:
            fan = k * k * cin
            ws.append(torch.randn((cout, cin, k, k), generator=g)
                      * np.sqrt(2.0 / fan))
            cin = cout
        ws.append(torch.randn((2 * cin, self.num_features), generator=g)
                  * np.sqrt(2.0 / (2 * cin)))
        self.weights = [w.float().to(self.device) for w in ws]

    def __call__(self, images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        if self.weights is None:
            self._build(x.shape[1])
        with torch.no_grad(), no_tf32():
            x = x / 127.5 - 1.0
            for w, (k, _, s) in zip(self.weights, self.LAYERS):
                x = F.relu(F.conv2d(_same_pad(x, k, s), w, stride=s))
            feats = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], 1)
            return (feats @ self.weights[-1]).cpu().numpy()


def make_lpips(spec: str, device="cuda"):
    """The LPIPS detector of a spec: "random-lpips[:seed]" -> RandomLPIPS;
    anything else is a TorchScript vgg16.pt path."""
    if spec == "random-lpips" or spec.startswith("random-lpips:"):
        seed = int(spec.split(":", 1)[1]) if ":" in spec else 0
        return RandomLPIPS(seed=seed, device=device)
    return TorchScriptDetector(spec, device, resize_images=False,
                               return_lpips=True)


RANDOM_INCEPTION = ("jax-random", "inception-random")
INCEPTION_FILE = ("jax:", "inception:")


def make_detector(spec: Optional[str], device="cuda") -> Callable:
    """The detector of a spec string (see the module's docstring), on
    `device` where it runs a network."""
    if spec is None or spec == "randproj":
        return RandomProjectionDetector()
    if spec in RANDOM_INCEPTION:
        return InceptionDetector.random(0, device)
    if spec.startswith(INCEPTION_FILE):
        return InceptionDetector.from_file(spec.split(":", 1)[1], device)
    return TorchScriptDetector(spec, device, return_features=True)


def detector_id(spec: Optional[str]) -> str:
    """The detector's id in the feature-stats cache key."""
    if spec in RANDOM_INCEPTION:
        return "torch-random-he"  # the port's draws, never flax's
    if spec is not None and spec.startswith(INCEPTION_FILE):
        return "inception:" + spec.split(":", 1)[1]
    return spec or "randproj"


def batched_features(images: Iterable, detector: Callable,
                     stats: Optional[FeatureStats] = None,
                     max_items: Optional[int] = None) -> FeatureStats:
    """Stream batches of uint8 NCHW images through a detector into
    stats."""
    if stats is None:
        stats = FeatureStats(capture_mean_cov=True, max_items=max_items)
    last = time.time()
    for batch in images:
        if stats.is_full():
            break
        stats.append(detector(batch))
        if time.time() - last > 120:  # a heartbeat for long passes
            print(f"[features] {stats.num_items} items", file=sys.stderr)
            last = time.time()
    return stats


def latents_to_uint8(images_pm1):
    """[-1, 1] float NCHW -> uint8 NCHW, truncating as the JAX one does
    (`clip((x + 1) * 127.5).astype(uint8)`); a tensor stays on its
    device."""
    if isinstance(images_pm1, torch.Tensor):
        return ((images_pm1.float() + 1) * 127.5).clamp(0, 255).to(
            torch.uint8)
    return np.clip((images_pm1 + 1) * 127.5, 0, 255).astype(np.uint8)
