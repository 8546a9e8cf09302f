"""norm_roofline.sample: the add + norm and norm + modulate kernels' share
of their roofline over the profiled calls."""

from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "norm", "add_norm", "norm_modulate")
