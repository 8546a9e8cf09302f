"""launches_per_call.sample: kernel launches in the profiled window over
its drift calls."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.launches() / ctx.trace.calls
