"""mfu.sample: the window's model FLOPs (counts/model.py) over its time, as
a share of the bf16 dense peak."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)
