"""optimizer_ms.train: device ms a step in the optimizer's kernels (the
copied optimizer class: multi_tensor_apply)."""

from perfbench import readers


def read(ctx):
    return readers.per_call_ms(ctx, "optimizer")
