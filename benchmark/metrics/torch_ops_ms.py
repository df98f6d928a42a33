"""Device ms a query in operations that are not the port's kernels
(torch's kernels, copies and memsets), from the trace of the window."""

from benchmark import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.window.answers:
        return None
    t = ctx.trace
    ns = sum(min(op.end, t.end) - max(op.start, t.start) for op in t.ops if yardstick.port_kernel(op.name) is None)
    return ns / 1e6 / len(ctx.window.answers)
