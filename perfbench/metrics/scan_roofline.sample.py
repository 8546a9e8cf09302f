"""scan_roofline.sample: the inference scan kernel's share of its roofline
over the profiled calls."""

from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "scan", "selective_scan")
