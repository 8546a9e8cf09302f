"""device_idle.train: share of the profiled steps' window with no operation
on the device."""

from perfbench import readers


def read(ctx):
    return readers.idle(ctx)
