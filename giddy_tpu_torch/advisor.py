"""Scheme advisor: pick the best scheme for a column by measuring.

Counterpart of giddy_tpu/advisor.py. Trial-encode a sample (or the whole
column) with every candidate through the port's host encoders, which are
byte-identical to the reference's, and rank by compressed size; ties break
toward cheaper decode. So ``suggest(v)`` ranks as the reference does and
``encode_best(v)`` writes the same column. With ``measure=True`` the
near-ties are settled by decode throughput timed on ``device`` (the card
unless ``"cpu"`` is asked), whose order may differ from the TPU's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import registry
from .format import EncodedColumn
from .util import GROUP

# Candidates in decode-cost order (cheapest first — the tiebreaker).
CANDIDATES = ["rle", "dict", "cascade", "bitmap", "nbit", "dzbf", "for", "delta", "delta2", "alp", "xordelta", "model", "dzbv", "patched"]


def suggest(
    values: np.ndarray,
    *,
    candidates: list[str] | None = None,
    sample_groups: int = 4,
    rng: np.random.Generator | None = None,
    measure: bool = False,
    tie_tol: float = 0.10,
    device: torch.device | str = "cuda",
) -> list[tuple[str, float]]:
    """Rank candidate schemes by estimated compression ratio on a sample.

    Returns [(scheme, estimated_ratio)] best-first; schemes whose encoder
    refuses the column are skipped, and bitmap above 64 distinct values.
    The sample is ONE contiguous whole-GROUP window (giddy_tpu/advisor.py:21
    says why). With ``measure=True``, candidates whose ratios are within
    ``tie_tol`` of the leader are re-ordered by measured decode throughput
    on ``device``."""
    values = np.asarray(values)
    n = values.shape[0]
    cands = candidates or CANDIDATES
    if n > sample_groups * GROUP:
        rng = rng or np.random.default_rng(0)
        ng = n // GROUP
        g0 = int(rng.integers(0, ng - sample_groups + 1))
        sample = values[g0 * GROUP : (g0 + sample_groups) * GROUP]
    else:
        sample = values
    results = []
    for scheme in cands:
        if scheme == "bitmap" and np.unique(sample).size > 64:
            continue  # decode cost explodes with cardinality
        col = _trial(sample, scheme, "_advise")
        if col is not None:
            results.append((scheme, col.nbytes_decoded / max(col.nbytes_compressed, 1)))
    results.sort(key=lambda t: (-t[1], CANDIDATES.index(t[0]) if t[0] in CANDIDATES else 99))
    if measure and len(results) > 1:
        k = 1
        while k < len(results) and results[k][1] >= results[0][1] * (1 - tie_tol):
            k += 1
        if k > 1:
            gbps = {s: _measure_decode_gbps(sample, s, device=device) for s, _ in results[:k]}
            results[:k] = sorted(results[:k], key=lambda t: -gbps[t[0]])
    return results


def _trial(values: np.ndarray, scheme: str, name: str) -> EncodedColumn | None:
    """The scheme's host encode of ``values``, or None where the scheme is
    unknown or its encoder refuses them (the reference skips those)."""
    try:
        return registry.get(scheme).encode(values, name=name)
    except Exception:  # any refusal: the reference's skip (advisor.py:60-63)
        return None


def _measure_decode_gbps(
    sample: np.ndarray, scheme: str, *, iters: int = 5, target_groups: int = 64,
    device: torch.device | str = "cuda",
) -> float:
    """Decode throughput (decoded GB/s) of ``scheme`` on the sample on
    ``device``, tiled to ~target_groups GROUPs so the measurement rises
    above launch latency; the host clock around a synchronise on the card.
    Returns 0.0 where the scheme cannot encode the sample; a decode that
    fails raises."""
    from .api import _decode_device, device_streams, get_decoder

    device = _decode_device(device)
    tiled = np.tile(sample, max(1, (target_groups * GROUP) // max(sample.shape[0], 1)))
    col = _trial(tiled, scheme, "_measure")
    if col is None:
        return 0.0
    fn = get_decoder(col)
    st = device_streams(col, device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(st)  # warm: builds the kernel library on first use
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(st)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return col.nbytes_decoded / max(dt, 1e-9) / 1e9


def encode_best(
    values: np.ndarray, *, name: str = "col", ranked: list[tuple[str, float]] | None = None, **kw
) -> EncodedColumn:
    """Encode with the advisor's top pick (raw if nothing beats 1.0x).
    Pass a precomputed ``ranked`` list (from suggest) to avoid re-running
    the trial encodes."""
    if ranked is None:
        ranked = suggest(values, **kw)
    best = ranked[0] if ranked and ranked[0][1] > 1.0 else ("raw", 1.0)
    return registry.get(best[0]).encode(np.asarray(values), name=name)
