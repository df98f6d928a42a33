"""Aggregate pushdown on the GPU: exact sum/min/max without the decoded
column.

Counterpart of giddy_tpu/aggregate.py. For nbit, dzbf and for the kernel
K17 (kernels/agg.py) folds each lane's 32 values into per-(group, lane)
partials; only (ng, LANES) partials are written, 1/32768 of the decoded
bytes each. Every other scheme decodes with its own kernel and folds with
the same slot math in torch ops (lanes.slot_fold) on the card.

Exactness: 64-bit sums accumulate as (lo, hi) uint32 pairs with explicit
carries; signed columns also count sign bits, and the true sum is
``S_unsigned - N_neg * 2**(8*w)``. The partials are summed in int64 on the
card (a lane adds at most 32 * 2^32, so 2^26 lanes stay below 2^63), and
the host finishes in Python ints. min/max reduce order keys (bias-mapped
ints, IEEE total-order floats). Float sums decode, copy to the host and
reduce in float64 with NumPy's own order, as the reference does.

Dictionary-backed columns (dict, cascade) sum as ``sum_c count_c *
dict_c``: ``torch.bincount`` over the codes that the code column decodes
(the value gather never runs), then an exact host dot in Python ints.
Every entry point takes ``device`` ("cuda", or "cpu" for the tests) with
no default.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nulls
from .api import _check_supported, _decode_device, decode, device_streams, get_decoder
from .format import EncodedColumn
from .groupby import _codes_device_column, key_values
from .kernels import lanes
from .kernels.agg import agg_fold
from .query import FUSED, _host_key_u32
from .util import GROUP, np_dtype, num_groups, u32_to_dtype


def _key_unmap_host(key: int, dtype: str):
    """Inverse of lanes.order_key for one host-side int32 key."""
    dt = np_dtype(dtype)
    if dt.kind == "i":
        return int(key)
    u = np.int32(key).view(np.uint32) ^ np.uint32(0x80000000)  # undo bias
    if dt.kind == "f":
        if u >> np.uint32(31):  # was non-negative: clear the sign flip
            u = u ^ np.uint32(0x80000000)
        else:  # was negative: undo the full flip
            u = u ^ np.uint32(0xFFFFFFFF)
        return u.view(np.float32).item()
    return int(u)


def _run(col: EncodedColumn, agg: str, device: torch.device) -> tuple:
    """The (ng, LANES) partials of ``agg`` (lanes.slot_fold): K17 for the
    fused schemes, the column's decoder and the slot fold otherwise. Null
    rows drop out of the sum; min/max read the canonical fill, which only
    repeats valid values."""
    dt = np_dtype(col.dtype)
    valid = nulls.valid_words_device(col, device) if agg == "sum" and nulls.is_nullable(col) else None
    streams = device_streams(col, device)
    if col.scheme in FUSED:
        bits = col.params["bits"] if col.scheme != "dzbf" else 8 * col.params["width"]
        return agg_fold(streams["packed"], streams.get("refs_g"), valid, bits, col.n, dt.kind, dt.itemsize, agg)
    u = get_decoder(col)(streams).view(num_groups(col.n), GROUP)
    return lanes.slot_fold(u, valid, col.n, dt.kind, dt.itemsize, agg)


def _code_counts(col: EncodedColumn, device: torch.device) -> np.ndarray:
    """Rows per dictionary code of a dict/cascade column, (d,) int64 on the
    host: the codes decode on the card (K1 for dict, the inner scheme's
    kernel without its table for cascade), rows >= n and null rows drop
    out. The counts of giddy_tpu's group_reduce(col, None, ("count",))."""
    codes = decode(_codes_device_column(col), device=device).to(torch.int64)
    if nulls.is_nullable(col):
        valid = lanes.unpack_lanes(nulls.valid_words_device(col, device), 1).reshape(-1)[: col.n]
        codes = codes[valid.bool()]
    d = col.params["dict_size"]
    return torch.bincount(codes, minlength=d)[:d].cpu().numpy()


def sum_(col: EncodedColumn, *, device: torch.device | str) -> int | float:
    """Exact column sum: Python ints for integer columns, a float64 host sum
    for floats. Nullable columns sum the non-null rows (SQL SUM)."""
    device = _decode_device(device)
    _check_supported(col)
    dt = np_dtype(col.dtype)
    if col.scheme in ("cascade", "dict") and dt.kind != "f":
        counts = _code_counts(col, device)
        vals = key_values(col).astype(np.int64)
        return int(sum(int(c) * int(v) for c, v in zip(counts, vals)))
    if dt.kind == "f":
        v = decode(col, device=device).cpu().numpy()
        if nulls.is_nullable(col):
            v = v[nulls.valid_mask(col)]
        return float(np.sum(v, dtype=np.float64))
    lo, hi, neg = ((p.to(torch.int64) & 0xFFFFFFFF).sum() for p in _run(col, "sum", device))
    s = int(lo.item()) + (int(hi.item()) << 32)
    if dt.kind == "i":
        s -= int(neg.item()) << (8 * dt.itemsize)
    return s


def _minmax(col: EncodedColumn, agg: str, device: torch.device | str):
    # nullable columns need no masking: the canonical fill only repeats
    # valid values, so the filled extreme IS the valid extreme, except
    # when every row is null
    if col.n == 0:  # same contract as the all-null case: no valid rows
        raise ValueError(f"{agg} of an empty column")
    device = _decode_device(device)
    _check_supported(col)
    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        raise ValueError(f"{agg} of an all-null column")
    dt = np_dtype(col.dtype)
    if col.scheme in ("cascade", "dict") and col.params.get("dense"):
        # auto-built dictionary: every entry appears at least once, so the
        # column extreme is the dictionary extreme (host, O(dict_size))
        u = col.streams["values"].view(np.uint32)
        if dt.kind == "f":
            keys = _host_key_u32(u)
            pick = int(np.argmax(keys)) if agg == "max" else int(np.argmin(keys))
            return u32_to_dtype(u[pick : pick + 1], col.dtype)[0].item()
        vals = u32_to_dtype(u, col.dtype)
        return int(vals.max() if agg == "max" else vals.min())
    (keys,) = _run(col, agg, device)
    best = keys.max() if agg == "max" else keys.min()
    return _key_unmap_host(int(best.item()), col.dtype)


def min_(col: EncodedColumn, *, device: torch.device | str):
    """Column minimum (floats: total-order semantics, NaN-aware)."""
    return _minmax(col, "min", device)


def max_(col: EncodedColumn, *, device: torch.device | str):
    """Column maximum (floats: total-order semantics, NaN-aware)."""
    return _minmax(col, "max", device)


def avg_(col: EncodedColumn, *, device: torch.device | str) -> float:
    """Column mean: exact sum / row count (float64). Nullable columns
    average the non-null rows (SQL AVG)."""
    nv = nulls.count_valid(col)
    if nv == 0:
        raise ValueError("avg of an empty (or all-null) column")
    return float(sum_(col, device=device)) / nv


def distinct_count(col: EncodedColumn, *, device: torch.device | str) -> int:
    """Number of distinct values (floats in bit-pattern space). Dense
    (auto-built) dictionaries answer from the header; other dictionary-
    backed columns count the codes in use; everything else decodes and
    counts uniques on the host. Nullable columns count distinct non-null
    values (the fill adds no new ones)."""
    device = _decode_device(device)
    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        return 0
    if col.scheme in ("cascade", "dict") and col.params.get("dense"):
        return col.params["dict_size"]
    if col.scheme in ("dict", "cascade"):
        return int(np.count_nonzero(_code_counts(col, device)))
    v = decode(col, device=device).cpu().numpy()
    if v.dtype.kind == "f":  # bit-pattern distinctness (NaN payloads)
        v = v.view(np.uint32)
    return int(np.unique(v).size)
