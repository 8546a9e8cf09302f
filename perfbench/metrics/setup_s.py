"""setup_s: seconds from the process's start to the first timed call
(loading, building the model and weights, warming up; in a checkout's
first run also compiling)."""


def read(ctx):
    return ctx.setup_s
