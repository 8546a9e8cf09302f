"""peak_mem_gb.train: max_memory_allocated over the window's steps, after
reset_peak_memory_stats, in GB."""


def read(ctx):
    peak = ctx.counters.get("window_memory_peak_bytes")
    return peak / 1e9 if peak else None
