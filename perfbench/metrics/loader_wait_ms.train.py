"""loader_wait_ms.train: the benchmark's span around next() on the device
batches, the mean over the window's steps, in ms."""


def read(ctx):
    waits = ctx.spans.get("loader_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
