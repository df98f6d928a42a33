"""Zone maps: per-GROUP min/max pruning and sorted-column search.

Counterpart of giddy_tpu/zonemap.py. A zone map stores the min and max of
every GROUP tile, so a selective scan decides per group: every row
matches (counted without a decode), none can (skipped), or undecided
(that group alone decodes on the card through partial.GroupSlicer).
``searchsorted`` uses the same map as a coarse index over a sorted
column: binary-search the group maxima, decode one group, finish inside it.

Ordering is on monotone keys: logical values for integers, IEEE
total-order bit-pattern keys for floats (query.py semantics: NaNs at the
extremes, -0.0 < +0.0). The map is built once from the NumPy oracle decode
(the load-time scan a database would make) and cached on the column.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .format import EncodedColumn
from .util import GROUP, NP_CMP, np_dtype, num_groups


def _keys(values: np.ndarray, dtype: str) -> np.ndarray:
    """Logical values -> monotone orderable keys (see the module docstring)."""
    dt = np_dtype(dtype)
    if dt.kind != "f":
        return values
    if dt.itemsize == 4:
        u = values.view(np.uint32)
        neg = np.where(u >> np.uint32(31), np.uint32(0xFFFFFFFF), np.uint32(0))
        return u ^ (np.uint32(0x80000000) | neg)
    u = values.view(np.uint64)
    neg = np.where(u >> np.uint64(63), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(0))
    return u ^ (np.uint64(0x8000000000000000) | neg)


def _key_scalar(value, dtype: str):
    dt = np_dtype(dtype)
    if dt.kind != "f":
        return value
    return _keys(np.array([value], dt), dtype)[0]


@dataclasses.dataclass
class ZoneMap:
    """Per-group [min, max] in key space; ``sorted_`` when the column's key
    sequence is nondecreasing (enables searchsorted)."""

    mins: np.ndarray  # (ng,) key dtype
    maxs: np.ndarray
    n: int
    dtype: str
    sorted_: bool

    @property
    def ng(self) -> int:
        return self.mins.shape[0]


def zone_map(col: EncodedColumn) -> ZoneMap:
    """The column's zone map: built on first use from one oracle decode and
    cached on the column object (whose streams are immutable by contract).
    The ragged last group pads with its own last key, so a reshape gives the
    reference's per-group bounds."""
    zm = col.__dict__.get("_zone_map")
    if zm is not None:
        return zm
    from .api import decode_ref

    keys = _keys(decode_ref(col), col.dtype)
    ng = num_groups(col.n)
    if col.n == 0:
        raise ValueError(f"zone map of the empty column {col.name!r}")
    tiles = np.pad(keys, (0, ng * GROUP - col.n), mode="edge").reshape(ng, GROUP)
    sorted_ = bool(np.all(keys[1:] >= keys[:-1])) if col.n > 1 else True
    zm = col._zone_map = ZoneMap(mins=tiles.min(1), maxs=tiles.max(1), n=col.n, dtype=col.dtype, sorted_=sorted_)
    return zm


# Per-op (definitely-all-true, definitely-all-false) group predicates on
# (zmin, zmax, key).
_PRUNE = {
    "lt": (lambda lo, hi, v: hi < v, lambda lo, hi, v: lo >= v),
    "le": (lambda lo, hi, v: hi <= v, lambda lo, hi, v: lo > v),
    "gt": (lambda lo, hi, v: lo > v, lambda lo, hi, v: hi <= v),
    "ge": (lambda lo, hi, v: lo >= v, lambda lo, hi, v: hi < v),
    "eq": (lambda lo, hi, v: (lo == v) & (hi == v), lambda lo, hi, v: (v < lo) | (v > hi)),
    "ne": (lambda lo, hi, v: (v < lo) | (v > hi), lambda lo, hi, v: (lo == v) & (hi == v)),
}


def candidate_groups(zm: ZoneMap, op: str, value) -> np.ndarray:
    """Boolean (ng,) mask of groups that might hold matches (all-false
    groups removed; all-true groups still set)."""
    _, all_false = _split_masks(zm, op, value)
    return ~all_false


def _split_masks(zm: ZoneMap, op: str, value):
    if op not in _PRUNE:
        raise ValueError(f"op must be one of {tuple(_PRUNE)}, got {op!r}")
    v = _key_scalar(value, zm.dtype)
    t_fn, f_fn = _PRUNE[op]
    return t_fn(zm.mins, zm.maxs, v), f_fn(zm.mins, zm.maxs, v)


def _group_len(g: int, n: int) -> int:
    return min((g + 1) * GROUP, n) - g * GROUP


def _group_decoder(col: EncodedColumn, device: torch.device | str):
    """g -> the logical values of group g, decoded on ``device``."""
    from .partial import GroupSlicer, decode_groups

    if col.scheme == "wide":
        return lambda g: decode_groups(col, int(g), int(g) + 1, device=device)
    slicer = GroupSlicer(col, device=device)
    return lambda g: slicer.decode(int(g), int(g) + 1)


def count_where_pruned(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda") -> int:
    """count_where that decodes only the undecided groups, on ``device``:
    all-true groups count by size, all-false groups are skipped. Null rows
    never count (the zone bounds over the canonical fill stay sound)."""
    from . import nulls
    from .kernels.filter_ import OPS

    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    zm = zone_map(col)
    all_true, all_false = _split_masks(zm, op, value)
    nullable = nulls.is_nullable(col)
    if nullable:
        vmask = nulls.valid_mask(col)
        words = np.ascontiguousarray(col.streams["valid"][all_true], dtype=np.uint32)
        count = int(np.unpackbits(words.view(np.uint8)).sum())
    else:
        count = sum(_group_len(int(g), col.n) for g in np.flatnonzero(all_true))
    undecided = np.flatnonzero(~all_true & ~all_false)
    if undecided.size == 0:
        return int(count)
    dec = _group_decoder(col, device)
    vk = _key_scalar(value, col.dtype)
    cmp = NP_CMP[op]
    for g in undecided:
        vals = _keys(dec(g), col.dtype)
        m = cmp(vals, vk)
        if nullable:
            m = m & vmask[int(g) * GROUP : int(g) * GROUP + vals.shape[0]]
        count += int(m.sum())
    return int(count)


def searchsorted(col: EncodedColumn, values, side: str = "left", *, device: torch.device | str = "cuda") -> np.ndarray:
    """np.searchsorted over a sorted compressed column: binary-search the
    zone-map maxima for each value's group, decode only those groups on
    ``device``, finish inside them. Raises if the column is not sorted."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    zm = zone_map(col)
    if not zm.sorted_:
        raise ValueError(f"column {col.name!r} is not sorted; searchsorted needs a sorted column")
    vals = np.asarray(values)
    scalar = vals.ndim == 0
    vk = _keys(np.atleast_1d(vals).astype(np_dtype(col.dtype)), col.dtype)
    g_of = np.searchsorted(zm.maxs, vk, side=side)
    out = np.empty(vk.shape, np.int64)
    dec = None
    for g in np.unique(g_of):
        m = g_of == g
        if g >= zm.ng:  # beyond every group's max: the append position
            out[m] = col.n
            continue
        dec = dec or _group_decoder(col, device)
        seg_k = _keys(dec(g), col.dtype)
        out[m] = int(g) * GROUP + np.searchsorted(seg_k, vk[m], side=side)
    return out[0] if scalar else out.reshape(vals.shape)
