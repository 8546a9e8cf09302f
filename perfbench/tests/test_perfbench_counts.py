"""The FLOP counts and the frozen kernel bounds."""

import importlib.util

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import reference
from perfbench.common import CHECKOUT, load_cell
from perfbench.counts import bounds
from perfbench.counts.model import call_flops, forward_macs, kernel_bounds


def tiny(family, **kw):
    base = dict(family=family, hidden_size=64, depth=4, patch_size=2,
                in_channels=4, num_classes=10, num_heads=4,
                use_attn_every_k_layers=2, d_state=16, d_conv=4, expand=2,
                img_resolution=16)
    base.update(kw)
    return base


def counted_macs(cfg, rows=2):
    """Multiply-adds of a forward of the reference, counted by PyTorch's
    FlopCounterMode on meta tensors."""
    net = reference.model.build(cfg)
    s = cfg["img_resolution"]
    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        net(torch.empty(rows, cfg["in_channels"], s, s), torch.empty(rows),
            torch.zeros(rows, dtype=torch.long))
    return fc.get_total_flops() / 2 / rows


@pytest.mark.parametrize("cfg", [tiny("dim"), tiny("dim", img_resolution=32),
                                 tiny("dit"), tiny("dit", depth=2)],
                         ids=["dim-L64", "dim-L256", "dit", "dit-depth2"])
def test_forward_macs_match_the_reference_counted(cfg):
    """The reference's causal conv computes W - 1 padded outputs more a
    channel than the algorithm needs (cut off after the conv)."""
    extra = 0
    if cfg["family"] == "dim":
        d_inner = cfg["expand"] * cfg["hidden_size"] // 2
        w = cfg["d_conv"]
        extra = 2 * cfg["depth"] * (w - 1) * d_inner * w
    assert forward_macs(cfg) + extra == counted_macs(cfg)


def test_forward_macs_by_hand():
    # one DiT block, hidden 64, L 16 (latent 8, patch 2): adaLN 64 x 384,
    # qkv 16 x 64 x 192, the two attention products 2 x 16 x 16 x 64, proj
    # 16 x 64 x 64, fc1 + fc2 2 x 16 x 64 x 256; patch 16 x 16 x 64;
    # timestep 256 x 64 + 64 x 64; final adaLN 64 x 128, linear
    # 16 x 64 x 16
    cfg = tiny("dit", depth=1, img_resolution=8)
    block = 24576 + 196608 + 32768 + 65536 + 524288
    assert forward_macs(cfg) == block + 16384 + 20480 + 8192 + 16384


def test_dit_xl2_512_against_the_published_count():
    """DiT-XL/2 at 512 px: 524.6 GMACs a forward (the DiT paper's
    "Gflops"); what the count leaves out or adds is the adaLN and
    embedding share, well under 1%."""
    cell = load_cell("dit-xl2.sample-512")
    macs = forward_macs(cell["model"])
    assert abs(macs / 524.6e9 - 1) < 0.005
    assert call_flops(cell, cell["model"]) == 2 * 32 * macs


def test_dim_l2_256_per_row():
    """DiM-L/2 at 256 px: the port's own FlopCounterMode count at PR 23
    was 191.94 GFLOP a row."""
    cell = load_cell("dim-l2.sample-256")
    assert abs(2 * forward_macs(cell["model"]) / 191.94e9 - 1) < 0.01


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_copy", CHECKOUT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_frozen_bounds_equal_chip_smoke():
    cs = _chip_smoke()
    x = bounds.scan_args(24, 256, 1024, 16, 32, torch.bfloat16)
    assert bounds.scan_bound(x) == cs.scan_bound(x)
    assert bounds.train_bounds(x, 16) == cs.train_bounds(x, 16)
    assert bounds.attn_bound(8, 1024, 16, 72, torch.bfloat16) == \
        cs.attn_bound(8, 1024, 16, 72, torch.bfloat16)
    flags = dict(branch=2, gate=2, res=4, total=4, w=4, rms=True)
    assert bounds.norm_bound(24 * 256 * 1024, 24, 1024, 2, flags) == \
        cs.norm_bound(24 * 256 * 1024, 24, 1024, 2, flags)
    assert bounds.convx_bound(24, 256, 1024, 4, 64, 2, 989e12) == \
        cs.convx_bound(24, 256, 1024, 4, 64, 2, 989e12)
    for name in ("HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "BF16_TC_FLOP_PER_S",
                 "TF32_TC_FLOP_PER_S", "SFU_EXP_PER_S"):
        assert getattr(bounds, name) == getattr(cs, name)


@pytest.mark.parametrize("name, launches", [
    ("dim-l2.sample-256", {"scan": 32, "conv_xproj": 32, "norm": 40}),
    ("dit-xl2.sample-512", {"attention": 28, "norm": 57}),
    ("dim-l2.sample-512", {"scan": 32, "conv_xproj": 32, "norm": 40,
                           "attention": 36}),
    ("dim-l2.train-256", {"scan_train": 128})])
def test_kernel_groups_of_each_cell(name, launches):
    """Each cell's groups, with the launches a call's work takes: a
    mixer's scan and conv + x_proj once each (32 mixers), the training
    scan pair's four passes, the norm sites, and the full-block
    attention at L 1024 (DiT: 28 blocks; DiM: 4 shared blocks and 32
    cross attentions)."""
    cell = load_cell(name)
    got = kernel_bounds(cell, cell["model"])
    assert {g: b.launches for g, b in got.items()} == launches
    assert all(b.seconds > 0 for b in got.values())


def test_norm_sites_count_the_kernels_launches():
    """The fused DiM-L/2 forward with the deferred tail launches add +
    norm 3 times and norm + modulate 37 times (chip_smoke's
    FUSED_LAUNCHES[2]); DiT-XL/2 with fused_norm 57 times."""
    from perfbench.counts.model import _norm_sites

    dim = load_cell("dim-l2.sample-256")["model"]
    sites = _norm_sites(dim, 128, 256, 1024)
    add = sum(c for c, f in sites if "gate" not in f and "res" in f
              and "branch" not in f)
    assert add == 3 and sum(c for c, _ in sites) == 40
    dit = load_cell("dit-xl2.sample-512")["model"]
    assert sum(c for c, _ in _norm_sites(dit, 32, 1024, 1152)) == 57
