"""conv_xproj_roofline.sample: the conv + x_proj kernel's share of its
roofline over the profiled calls."""

from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "conv_xproj", "conv_xproj")
