"""device_idle.sample: share of the profiled drift calls' window with no
operation on the device."""

from perfbench import readers


def read(ctx):
    return readers.idle(ctx)
