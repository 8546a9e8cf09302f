"""mfu.train: a training step's model FLOPs (3 forwards) over the window's
time, as a share of the bf16 dense peak."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)
