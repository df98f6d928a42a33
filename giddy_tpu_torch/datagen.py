"""Synthetic column generators (counterpart of giddy_tpu/datagen.py).

NumPy only; the CPU tests hold :func:`gen_column` byte for byte to the
reference's for every scheme, so the same seed gives the same columns in
both packages (``chip_smoke.py`` builds BASELINE configs[4] with it, as
bench.py's ``bench_mixed`` does).
"""

from __future__ import annotations

import numpy as np

# The core single-column scheme matrix (SURVEY.md §3.1–3.2), as in the
# reference.
CORE_SCHEMES = [
    "nbit", "for", "delta", "delta2", "dict", "rle", "rpe", "model",
    "bitmap", "dzbf", "dzbv", "patched", "raw", "cascade", "xordelta",
    "alp",
]


def _runs(rng: np.random.Generator, n: int, lo: int, hi: int, pick) -> np.ndarray:
    """n int32 values in runs of lo..hi-1, each run's value from pick()."""
    out = np.zeros(n, dtype=np.int32)
    pos = 0
    while pos < n:
        ln = int(rng.integers(lo, hi))
        out[pos : pos + ln] = pick()
        pos += ln
    return out


def gen_column(scheme: str, n: int, rng: np.random.Generator, *, hard: bool = False,
               frame_len: int = 32768) -> np.ndarray:
    """Data a given scheme compresses well (or, hard=True, adversarially).
    ``frame_len`` is the model column's segment length (the reference's is
    fixed at GROUP, the default)."""
    if scheme in ("nbit", "dzbf"):
        hi = 2**31 - 1 if hard else 511  # 9-bit case = BASELINE configs[0]
        return rng.integers(0, hi + 1, n, dtype=np.int64).astype(np.int32)
    if scheme == "for":
        base = np.int32(1_700_000_000)
        return (base + rng.integers(0, 4096, n)).astype(np.int32)
    if scheme == "alp":
        # decimal float32 (price-like: 2 fractional digits); hard = raw
        # random floats, where nearly everything becomes an exception
        if hard:
            return rng.random(n).astype(np.float32)
        return np.round(rng.uniform(0, 1000, n), 2).astype(np.float32)
    if scheme == "xordelta":
        # slowly varying float32 (sensor trace)
        steps = rng.normal(0, 1e-3 if not hard else 1e6, n)
        return (np.cumsum(steps) + 300.0).astype(np.float32)
    if scheme == "delta":
        # sorted timestamps (BASELINE configs[1])
        steps = rng.integers(0, 16 if not hard else 2**20, n)
        return np.cumsum(steps).astype(np.int32) + np.int32(1_600_000_000)
    if scheme == "model":
        # piecewise polynomial segments, one per frame: curvature where
        # c != 0, plain ramps where c == 0; hard = wide noise. At frame_len
        # 4·GROUP a curved arc spans 2^32 and wraps.
        fl = frame_len
        nf = (n + fl - 1) // fl or 1
        c = rng.integers(-1, 2, nf)
        b = rng.integers(-50, 50, nf)
        a = rng.integers(2**28, 2**29, nf)  # keeps every arc in [0, 2^31)
        noise = rng.integers(-7, 8 if not hard else 2**20, n)
        p = np.arange(n, dtype=np.int64)
        f, q = p // fl, p % fl
        v = a[f] + b[f] * q + c[f] * q * (q - (fl - 1)) + noise
        return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if scheme == "delta2":
        # regularly sampled timestamps with clock jitter; hard = random
        # walk of the interval
        steps = 1000 + rng.integers(0, 4 if not hard else 2**20, n)
        return np.cumsum(steps).astype(np.int32) + np.int32(1_600_000_000)
    if scheme == "dict":
        d = 2**16 if hard else 40
        vocab = rng.integers(-(2**31), 2**31 - 1, d, dtype=np.int64).astype(np.int32)
        return vocab[rng.integers(0, d, n)]
    if scheme in ("rle", "rpe"):
        if hard:
            return rng.integers(0, 3, n).astype(np.int32)  # runs of ~1
        # status flags: long runs (BASELINE configs[3])
        return _runs(rng, n, 100, 5000, lambda: int(rng.integers(0, 5)))
    if scheme == "bitmap":
        d = 12 if hard else 4
        vocab = rng.integers(-100, 100, d, dtype=np.int64).astype(np.int32)
        return vocab[rng.integers(0, d, n)]
    if scheme == "dzbv":
        mag = rng.integers(0, 4, n)
        v = rng.integers(0, 2**31 - 1, n, dtype=np.int64)
        return (v % (2 ** (8 * (mag + 1)))).astype(np.uint32).view(np.int32)
    if scheme == "patched":
        v = rng.integers(0, 255, n, dtype=np.int64).astype(np.int32)
        if n:
            out_idx = rng.choice(n, max(1, n // 100), replace=False)
            v[out_idx] = rng.integers(2**20, 2**30, out_idx.shape[0])
        return v
    if scheme == "raw":
        return rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    if scheme == "cascade":
        # low-cardinality values in long runs (RLE_DICTIONARY's sweet spot)
        d = 2**12 if hard else 8
        vocab = rng.integers(-(2**31), 2**31 - 1, d, dtype=np.int64).astype(np.int32)
        if hard:
            return vocab[rng.integers(0, d, n)]
        return _runs(rng, n, 50, 2000, lambda: vocab[int(rng.integers(0, d))])
    if scheme == "wide":
        # 64-bit epoch-nano timestamps: hi plane near-constant
        return (np.int64(1_700_000_000_000_000_000) + np.cumsum(rng.integers(0, 1000, n))).astype(np.int64)
    raise ValueError(scheme)
