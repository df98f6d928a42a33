"""The 95th percentile, in ms, over every query of the window, each timed
from its first call to its count on the host (host clock)."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
