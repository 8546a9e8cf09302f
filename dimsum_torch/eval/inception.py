"""InceptionV3 for FID as `nn.Module`s, port of
`dimsum_tpu/eval/inception.py`: pytorch-fid's variant of torchvision's
`inception_v3`, returning the (N, 2048) pool3 features.

* BasicConv2d is a bias-free conv, BatchNorm (inference, eps 1e-3) and
  ReLU.  InceptionA, C and Mixed_7b pool by 3 x 3 averages with padding 1
  and `count_include_pad=False`; Mixed_7c's pool branch takes the **max**
  (the original TF graph, pytorch-fid's FIDInceptionE_2).
* Parameter names are torchvision's (`Mixed_5b.branch1x1.conv.weight`,
  `....bn.running_var`), so a pytorch-fid `pt_inception-2015-12-05-*.pth`
  loads strictly once `fc.*` and `AuxLogits.*` are dropped
  (`load_inception_state_dict`).
* `preprocess_uint8` is pytorch-fid's: uint8 NCHW / 255, `F.interpolate`
  to 299 x 299 (bilinear, align_corners=False, no antialias), 2x - 1.  The
  JAX package resizes with `jax.image.resize`, which antialiases when it
  shrinks: equal at 64 and 256 px, up to 0.537 apart at 512 px.

`InceptionDetector` runs the network on a device (the card unless the
caller asks for the CPU) in fp32 with TF32 off, from uint8 images given as
a numpy array or as a tensor already on the device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dimsum_torch.eval.fid import no_tf32

SIZE = 299
BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm(eps 1e-3, inference) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool  # "avg" (Mixed_7b) or "max" (Mixed_7c)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max"
              else _avg_pool(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


class InceptionV3Features(nn.Module):
    """Input NCHW float in [-1, 1] at 299 x 299; output (N, 2048) pool3."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def preprocess_uint8(images: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """uint8 NCHW (any H x W) -> float32 NCHW in [-1, 1] at size x size,
    pytorch-fid's resize: bilinear, align_corners=False, no antialias.  An
    image already at size x size is not resampled."""
    x = images.float() / 255.0
    if x.shape[2] != size or x.shape[3] != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False)
    return 2.0 * x - 1.0


@torch.no_grad()
def random_init_inception_(model: InceptionV3Features,
                           seed: int = 0) -> InceptionV3Features:
    """Seeded He-scaled weights (variance 2 / fan_in, as the JAX package's
    `jax-random` detector scales flax's init; without it the features
    collapse through ~94 ReLU layers and FID goes to ~0), BN at identity
    (weight 1, bias 0, mean 0, var 1).  Drawn on the CPU from one
    generator, so the same seed gives the same weights on any device."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=g)
            m.weight.copy_(w * math.sqrt(2.0 / fan_in))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def load_inception_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch-fid InceptionV3 state dict
    (`pt_inception-2015-12-05-*.pth`, `inception_v3_google-*.pth`) from a
    local file, without `fc.*` and `AuxLogits.*` (the classifier, unused
    for pool3); BN's `num_batches_tracked`, which some files leave out and
    inference never reads, filled with 0 where absent."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("fc.", "AuxLogits."))}
    for k in [k for k in sd if k.endswith(".bn.running_var")]:
        sd.setdefault(k[:-len("running_var")] + "num_batches_tracked",
                      torch.tensor(0, dtype=torch.long))
    return sd


class InceptionDetector:
    """uint8 NCHW images -> (N, 2048) float32 pool3 features (numpy), the
    network on `device` in fp32 with cuDNN's and the matmuls' TF32 off.
    Images may be a numpy array or a uint8 tensor (on the device already:
    the streaming path hands over decoded images without a host copy)."""

    def __init__(self, model: InceptionV3Features, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).float().eval().requires_grad_(
            False)

    @classmethod
    def random(cls, seed: int = 0, device="cuda") -> "InceptionDetector":
        return cls(random_init_inception_(InceptionV3Features(), seed),
                   device)

    @classmethod
    def from_file(cls, path: str, device="cuda") -> "InceptionDetector":
        model = InceptionV3Features()
        model.load_state_dict(load_inception_state_dict(path), strict=True)
        return cls(model, device)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """The features as a tensor on the device."""
        with torch.no_grad(), no_tf32():
            x = torch.as_tensor(images).to(self.device)
            return self.model(preprocess_uint8(x))

    def __call__(self, images) -> np.ndarray:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return self.features(images).cpu().numpy()

