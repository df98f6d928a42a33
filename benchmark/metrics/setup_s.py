"""Seconds from the start of the process to the start of the window:
imports, data drawn on the card, the host encode, the upload of the
streams, the decoders and every shape warmed up (host clock)."""


def read(ctx):
    return ctx.setup_s
