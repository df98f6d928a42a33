"""Host us to queue one decode call: the benchmark's clock around the
decoder call alone (no synchronise), the mean over an untraced window's
calls, so that neither the profiler nor its ranges are in it."""


def read(ctx):
    s = ctx.clock.issue_s if ctx.clock is not None else None
    return 1e6 * sum(s) / len(s) if s else None
