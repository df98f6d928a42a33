"""Queries answered in the window, over the window's seconds (host clock)."""


def read(ctx):
    w = ctx.window
    return len(w.answers) / w.seconds if w.answers else None
