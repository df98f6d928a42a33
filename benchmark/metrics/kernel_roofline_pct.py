"""The port's kernels' least time as a share of their device time in the
traced window, in %: each launch's least bytes (yardstick.least_bytes: the
column's encoded streams read once, its output written once) at the
yardstick's memory rate, over the launches' device time. None without a
trace, without a port kernel, or where a port kernel has no byte count or
no program call to tie it to."""

from benchmark import yardstick


def read(ctx):
    if ctx.trace is None:
        return None
    least = busy = 0.0
    for op in ctx.trace.ops:
        kernel = yardstick.port_kernel(op.name)
        if kernel is None:
            continue
        column = op.span.split(":", 1)[1] if op.span and ":" in op.span else None
        if column not in ctx.columns:
            return None
        stream_bytes, n, itemsize = ctx.columns[column]
        b = yardstick.least_bytes(kernel, stream_bytes, n, itemsize)
        if b is None:
            return None
        least += b / yardstick.HBM_BYTES_PER_S
        busy += (op.end - op.start) / 1e9
    return 100.0 * least / busy if busy > 0 else None
