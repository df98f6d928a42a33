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
dict_c``: the code counts of ``groupby.group_count`` over the codes that
the code column decodes (the value gather never runs), then an exact host
dot in Python ints. 64-bit (wide) columns sum per 32-bit plane (exact in
Python ints, the sign from a count of negative hi planes) and take min/max
from their zone map.
Every entry point takes ``device``, the card unless the caller asks for
``"cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nulls
from .api import _check_supported, _decode_device, decode, device_streams, get_decoder
from .format import EncodedColumn
from .groupby import group_count, key_values
from .kernels import lanes
from .kernels.agg import agg_fold
from .query import FUSED, _host_key_u32
from .util import GROUP, check_device_addressable, np_dtype, num_groups, u32_to_dtype


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


def _run(col: EncodedColumn, agg: str, device: torch.device, streams: dict | None = None) -> tuple:
    """The (ng, LANES) partials of ``agg`` (lanes.slot_fold): K17 for the
    fused schemes, the column's decoder and the slot fold otherwise. Null
    rows drop out of the sum; min/max read the canonical fill, which only
    repeats valid values. ``streams``: the column's streams already on
    ``device`` in device form (a partial.GroupSlicer slice's, validity
    window included), uploaded here when None."""
    check_device_addressable(col.n, f"aggregate of {col.name!r}")
    _check_supported(col)
    dt = np_dtype(col.dtype)
    if streams is None:
        streams = device_streams(col, device)
    valid = None
    if agg == "sum" and nulls.is_nullable(col):
        valid = streams["valid"] if "valid" in streams else nulls.valid_words_device(col, device)
    if col.scheme in FUSED:
        bits = col.params["bits"] if col.scheme != "dzbf" else 8 * col.params["width"]
        return agg_fold(streams["packed"], streams.get("refs_g"), valid, bits, col.n, dt.kind, dt.itemsize, agg)
    u = get_decoder(col)(streams).view(num_groups(col.n), GROUP)
    return lanes.slot_fold(u, valid, col.n, dt.kind, dt.itemsize, agg)


def sum_(col: EncodedColumn, *, device: torch.device | str = "cuda") -> int | float:
    """Exact column sum: Python ints for integer columns, a float64 host sum
    for floats. Nullable columns sum the non-null rows (SQL SUM)."""
    device = _decode_device(device)
    dt = np_dtype(col.dtype)
    if col.scheme in ("cascade", "dict") and dt.kind != "f":
        # rows per code (null rows drop out: group_count ANDs the validity
        # words in), then the exact host dot
        counts = group_count(col, device=device).count
        vals = key_values(col).astype(np.int64)
        return int(sum(int(c) * int(v) for c, v in zip(counts, vals)))
    if dt.kind == "f":
        v = decode(col, device=device)  # NumPy already for a column decoded in chunks
        v = v if isinstance(v, np.ndarray) else v.cpu().numpy()
        if nulls.is_nullable(col):
            v = v[nulls.valid_mask(col)]
        return float(np.sum(v, dtype=np.float64))
    if col.scheme == "wide":
        from . import wide
        from .partial import take
        from .query import count_where

        s = sum_(wide._sub(col, "lo"), device=device) + (sum_(wide._sub(col, "hi"), device=device) << 32)
        if dt.kind == "i":  # two's complement: 2^64 less for each negative
            s -= count_where(wide._sub(col, "hi"), "ge", 1 << 31, device=device) << 64
        if nulls.is_nullable(col):
            # the plane sums covered the fill values at null rows: subtract
            # them exactly (take decodes only the groups that hold nulls)
            s -= sum(int(x) for x in take(col, nulls.null_positions(col), device=device))
        return s
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
    if col.scheme == "wide":
        # the zone map's keys: logical values for ints, total-order bits for floats
        from .zonemap import zone_map

        zm = zone_map(col)
        k = zm.maxs.max() if agg == "max" else zm.mins.min()
        if dt.kind != "f":
            return int(k)
        u = np.uint64(k)
        u = u ^ (np.uint64(0x8000000000000000) if u >> np.uint64(63) else np.uint64(0xFFFFFFFFFFFFFFFF))
        return u.view(np.float64).item()
    (keys,) = _run(col, agg, device)
    best = keys.max() if agg == "max" else keys.min()
    return _key_unmap_host(int(best.item()), col.dtype)


def min_(col: EncodedColumn, *, device: torch.device | str = "cuda"):
    """Column minimum (floats: total-order semantics, NaN-aware)."""
    return _minmax(col, "min", device)


def max_(col: EncodedColumn, *, device: torch.device | str = "cuda"):
    """Column maximum (floats: total-order semantics, NaN-aware)."""
    return _minmax(col, "max", device)


def avg_(col: EncodedColumn, *, device: torch.device | str = "cuda") -> float:
    """Column mean: exact sum / row count (float64). Nullable columns
    average the non-null rows (SQL AVG)."""
    nv = nulls.count_valid(col)
    if nv == 0:
        raise ValueError("avg of an empty (or all-null) column")
    return float(sum_(col, device=device)) / nv


def distinct_count(col: EncodedColumn, *, device: torch.device | str = "cuda") -> int:
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
        return int(np.count_nonzero(group_count(col, device=device).count))
    v = decode(col, device=device).cpu().numpy()
    if v.dtype.kind == "f":  # bit-pattern distinctness (NaN payloads)
        v = v.view(np.uint64 if v.dtype.itemsize == 8 else np.uint32)
    return int(np.unique(v).size)
