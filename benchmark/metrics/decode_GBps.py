"""Logical decoded bytes (n values of each column's dtype) of every round
finished in the window, over the window's seconds (host clock)."""


def read(ctx):
    w = ctx.window
    return w.decoded_bytes / w.seconds / 1e9 if w.rounds else None
