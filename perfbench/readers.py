"""The arithmetic the metric readers (`metrics/<name>.py`) share.  Each
reader returns a number, or None where the run has nothing to read: a
traced quantity in an untraced run, a kernel no launch of which is in the
trace."""

from __future__ import annotations

import sys


def rate(ctx) -> float:
    """Images a second over the whole timed window: every call's images
    over all its time."""
    return ctx.calls * ctx.images_per_call / ctx.window_s


def mfu(ctx) -> float:
    """Model FLOPs of the window's calls over the window's time, as a
    share (%) of the card's bf16 dense peak."""
    return 100.0 * ctx.flops_per_call * ctx.calls / (
        ctx.window_s * ctx.peak_flops)


def idle(ctx):
    """Share (%) of the profiled window in which no operation ran on the
    device."""
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def roofline(ctx, group: str, *classes: str):
    """Least time of the profiled calls' work in the kernels of
    `classes` (`ctx.bounds[group]`, a call's work at the cell's shapes)
    over those kernels' device time, as a share (%).  None where the
    trace holds another number of launches than that work takes: a site
    that left the kernels, or a route that launches them at other
    shapes, would change the time and leave the bound as it was."""
    if ctx.trace is None or group not in ctx.bounds:
        return None
    bound = ctx.bounds[group]
    launches = ctx.trace.launches(*classes)
    device_s = ctx.trace.device_s(*classes)
    if launches != bound.launches * ctx.trace.calls or device_s <= 0:
        print(f"{group}: {launches} launches in {ctx.trace.calls} calls, "
              f"the bound's work takes {bound.launches} a call: no "
              f"roofline", file=sys.stderr)
        return None
    return 100.0 * bound.seconds * ctx.trace.calls / device_s


def per_call_ms(ctx, *classes: str):
    """Device ms a call in the kernels of `classes`."""
    if ctx.trace is None or ctx.trace.launches(*classes) == 0:
        return None
    return 1e3 * ctx.trace.device_s(*classes) / ctx.trace.calls
