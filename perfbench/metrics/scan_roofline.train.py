"""scan_roofline.train: the training scan pair's share of its roofline
over the profiled steps."""

from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "scan_train", "selective_scan_fwd_train",
                            "selective_scan_bwd")
