"""attn_roofline.sample: the full-block attention kernel's share of its
roofline over the profiled calls."""

from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "attention", "full_block_attention")
