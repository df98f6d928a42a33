"""The share of the traced window, in %, with nothing running on the device."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_seconds() / ctx.trace.seconds)
