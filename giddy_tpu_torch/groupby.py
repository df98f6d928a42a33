"""Grouped aggregates (GROUP BY pushdown) on the card: per-key count, sum,
min and max computed from the codes of a dictionary-backed key column.

Counterpart of giddy_tpu/groupby.py. The key column's codes decode with
their own kernel (never its values: the gather is skipped), the measure
decodes with its own, and torch ops reduce between them on the card:
``index_add_`` into d + 1 buckets for counts and sums (pad rows and rows
the filter bitmap clears go to bucket d, dropped on the host), and
``scatter_reduce_`` ("amin"/"amax", ``include_self=False``) over the
measure's order keys (kernels/lanes.order_key) for min and max. Only
O(dict_size) partials cross back to the host.

Exactness (the reference's contract):

- integer sums are exact. The reference sums 8-bit byte planes in chunks of
  256 groups so that no uint32 wraps; here each value sums as an int64 (a
  32-bit value times fewer than 2^31 rows stays below 2^63), which gives
  the same int64 totals;
- 64-bit (wide) measures sum per 32-bit plane: lo unsigned, hi in the
  logical signedness, recombined on the host in Python ints; their
  min/max reduce on int64 order keys of the recombined values;
- float sums reduce on the host in float64 with ``np.add.at`` after a
  decode on the card (aggregate.sum_'s rounding stance);
- empty groups carry the reductions' identities as the reference leaves
  them (callers mask on count).

Every entry point takes ``device`` (the card unless ``"cpu"`` is asked).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .format import EncodedColumn
from .util import LANES, np_dtype, num_groups, u32_to_dtype

_AGGS = ("count", "sum", "min", "max")

_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1


# --- key-column code access -------------------------------------------------


def _codes_device_column(keys: EncodedColumn) -> EncodedColumn:
    """An int32 column decoding to the key codes, memoized on the parent
    so repeated scans reuse one object (giddy_tpu/groupby.py:53-62)."""
    cached = keys.__dict__.get("_codes_col")
    if cached is None:
        cached = keys._codes_col = _build_codes_column(keys)
    return cached


def _build_codes_column(keys: EncodedColumn) -> EncodedColumn:
    if keys.scheme == "strdict":
        from .strings import codes_column

        return codes_column(keys)
    if keys.scheme == "cascade":
        from .ref.cascade import codes_column

        return codes_column(keys)
    if keys.scheme == "dict":
        return EncodedColumn(
            name=f"{keys.name}._codes",
            scheme="nbit",
            dtype="int32",
            n=keys.n,
            params={"bits": keys.params["bits"]},
            streams={"packed": keys.streams["codes"]},
        )
    raise ValueError(
        f"group keys must be a 'dict', 'cascade' or 'strdict' column, got {keys.scheme!r}"
        " (encode the key column with gtt.encode(v, 'cascade'))"
    )


def key_values(keys: EncodedColumn) -> np.ndarray:
    """The dictionary (code -> key value), logical dtype, length d."""
    if keys.scheme == "strdict":
        from .strings import dictionary

        return dictionary(keys)
    return u32_to_dtype(keys.streams["values"].view(np.uint32), keys.dtype)


def _codes_on(keys: EncodedColumn, device: torch.device) -> torch.Tensor:
    """The (n_pad,) int32 key codes, decoded on ``device``."""
    from .api import device_streams, get_decoder

    ccol = _codes_device_column(keys)
    return get_decoder(ccol)(device_streams(ccol, device))


def _codes_host(keys: EncodedColumn, device: torch.device | str = "cuda") -> np.ndarray:
    """The n key codes as host int64: decoded on ``device``, then copied."""
    from .api import _decode_device

    return _codes_on(keys, _decode_device(device))[: keys.n].cpu().numpy().astype(np.int64)


# --- device program ----------------------------------------------------------


def bitmap_rows(words: torch.Tensor) -> torch.Tensor:
    """(ng, LANES) LMP(1) words -> (ng*GROUP,) bool, one a row: K1 at one
    bit, stored a byte a row."""
    from .kernels.nbit import lmp_unpack

    return lmp_unpack(words.contiguous(), 1, torch.uint8).reshape(-1).bool()


def _segments(keys: EncodedColumn, bitmap: torch.Tensor | None, device: torch.device) -> torch.Tensor:
    """(n_pad,) int64 bucket of every row: its code, or d for pad rows and
    rows the bitmap clears."""
    d = keys.params["dict_size"]
    codes = _codes_on(keys, device).to(torch.int64)
    valid = torch.arange(codes.shape[0], device=device) < keys.n
    if bitmap is not None:
        valid &= bitmap_rows(bitmap)
    return torch.where(valid, codes, d)


def _value_i64(u: torch.Tensor, kind: str, itemsize: int) -> torch.Tensor:
    """int32-carried payloads -> their logical integer values as int64."""
    from .kernels import lanes

    if kind == "i":
        return lanes.order_key(u, kind, itemsize).to(torch.int64)
    return u.to(torch.int64) & 0xFFFFFFFF


def _bucket_sum(seg: torch.Tensor, v: torch.Tensor, d: int) -> torch.Tensor:
    return torch.zeros(d + 1, dtype=v.dtype, device=seg.device).index_add_(0, seg, v)


def _bucket_extreme(seg: torch.Tensor, k: torch.Tensor, d: int, agg: str) -> torch.Tensor:
    """Per-bucket min or max of keys ``k``; an empty bucket keeps the
    identity (the dtype's max for min, its min for max)."""
    info = torch.iinfo(k.dtype)
    init = info.max if agg == "min" else info.min
    out = torch.full((d + 1,), init, dtype=k.dtype, device=seg.device)
    return out.scatter_reduce_(0, seg, k, "amin" if agg == "min" else "amax", include_self=False)


def _run_device(keys, vals, bitmap, device, *, want_count: bool, want_sum: bool, want_minmax: bool) -> dict:
    """One pass over the key codes (and the decoded measure): a dict of
    (d + 1,) host partials, bucket d the dropped rows."""
    from .api import device_streams, get_decoder

    seg = _segments(keys, bitmap, device)
    u = None
    if vals is not None and (want_sum or want_minmax):
        u = get_decoder(vals)(device_streams(vals, device))
    parts = _fold(seg, u, vals.dtype if vals is not None else None, keys.params["dict_size"],
                  want_count=want_count, want_sum=want_sum, want_minmax=want_minmax)
    return {k: t.cpu().numpy() for k, t in parts.items()}


def _fold(seg: torch.Tensor, u: torch.Tensor | None, dtype: str | None, d: int, *, want_count: bool,
          want_sum: bool, want_minmax: bool) -> dict:
    """The (d + 1,) device partials of one pass: row counts, int64 sums
    and order-key extremes of the measure payloads ``u`` (None: counts
    only) over the buckets ``seg``."""
    from .kernels import lanes

    parts = {}
    if want_count:
        parts["count"] = _bucket_sum(seg, torch.ones_like(seg), d)
    if u is not None:
        dt = np_dtype(dtype)
        if want_sum:
            parts["sum"] = _bucket_sum(seg, _value_i64(u, dt.kind, dt.itemsize), d)
        if want_minmax:
            k = lanes.order_key(u, dt.kind, dt.itemsize)
            parts["min"] = _bucket_extreme(seg, k, d, "min")
            parts["max"] = _bucket_extreme(seg, k, d, "max")
    return parts


def _unmap_keys_host(k: np.ndarray, dtype: str) -> np.ndarray:
    """Inverse of lanes.order_key on host int32 keys -> logical values
    (int64 for integers, float32 for floats); rows holding an identity
    (empty groups) come out as whatever it maps to: callers mask on count."""
    dt = np_dtype(dtype)
    if dt.kind == "i":
        return k.astype(np.int64)
    u = k.view(np.uint32) ^ np.uint32(0x80000000)  # undo the sign bias
    if dt.kind == "f":
        u = np.where(
            u >> np.uint32(31),
            u ^ np.uint32(0x80000000),  # was non-negative: clear the sign flip
            u ^ np.uint32(0xFFFFFFFF),  # was negative: undo the full flip
        ).astype(np.uint32)
        return u.view(np.float32)
    return u.astype(np.int64)


def _wide_keys(v: torch.Tensor, kind: str) -> torch.Tensor:
    """int64 bits of a 64-bit column -> int64 keys whose signed order is
    the logical dtype's (floats in IEEE total order)."""
    if kind == "i":
        return v
    if kind == "f":
        return v ^ ((v >> 63) & _I64_MAX)
    return v ^ _I64_MIN


def _unmap_wide_keys_host(k: np.ndarray, dtype: str) -> np.ndarray:
    """Inverse of :func:`_wide_keys` on host int64 keys."""
    dt = np_dtype(dtype)
    if dt.kind == "i":
        return k.astype(np.int64)
    u = k.view(np.uint64) ^ np.uint64(0x8000000000000000)
    if dt.kind == "f":
        top, allf = np.uint64(0x8000000000000000), np.uint64(0xFFFFFFFFFFFFFFFF)
        return np.where(u >> np.uint64(63), u ^ top, u ^ allf).astype(np.uint64).view(np.float64)
    return u


# --- host finishes ------------------------------------------------------------


def _host_mask(n: int, bitmap: torch.Tensor | None) -> np.ndarray | None:
    if bitmap is None:
        return None
    from .ref.lmp import lmp_unpack

    words = bitmap.cpu().numpy().view(np.uint32).reshape(num_groups(n), LANES)
    return lmp_unpack(words, 1, n).astype(bool)


def _host_decoded(vals: EncodedColumn, device: torch.device) -> np.ndarray:
    from .api import decode

    return decode(vals, device=device).cpu().numpy()


def _host_group_sum_float(codes, v, d, mask) -> np.ndarray:
    if mask is not None:
        codes, v = codes[mask], v[mask]
    s = np.zeros(d, np.float64)
    np.add.at(s, codes, v.astype(np.float64))
    return s


def _and_validity(bitmap, device: torch.device, *cols):
    """AND the validity words of any nullable columns into the filter
    bitmap (on ``device``): a row null in the key or the measure drops out."""
    from . import nulls

    for c in cols:
        if c is not None and nulls.is_nullable(c):
            vw = nulls.valid_words_device(c, device)
            bitmap = vw if bitmap is None else bitmap & vw
    return bitmap


# --- public API ----------------------------------------------------------------


@dataclass
class GroupResult:
    """Per-dictionary-entry aggregates. ``keys[i]`` is the i-th dictionary
    value; rows with ``count == 0`` (possible only with explicit
    dictionaries or a filter) have undefined min/max and zero sums."""

    keys: np.ndarray
    count: np.ndarray
    sum: np.ndarray | None = None
    min: np.ndarray | None = None
    max: np.ndarray | None = None


def group_reduce(
    keys: EncodedColumn,
    vals: EncodedColumn | None = None,
    aggs: tuple[str, ...] = ("count",),
    bitmap=None,
    *,
    device: torch.device | str = "cuda",
) -> GroupResult:
    """GROUP BY ``keys`` computing ``aggs`` over ``vals`` (optionally only
    where ``bitmap``, a filter_bitmap over any same-length column, is set).
    ``keys`` must be dictionary-backed ('dict', 'cascade' or 'strdict');
    ``vals`` may use any scheme, wide included. One row per dictionary
    entry. Rows whose key or measure is null drop out of every aggregate."""
    from .api import _check_supported, _decode_device

    device = _decode_device(device)
    aggs = tuple(aggs)
    for a in aggs:
        if a not in _AGGS:
            raise ValueError(f"agg must be one of {_AGGS}, got {a!r}")
    need_vals = any(a != "count" for a in aggs)
    if need_vals and vals is None:
        raise ValueError("sum/min/max require a values column")
    if vals is not None and vals.n != keys.n:
        raise ValueError(f"length mismatch: keys n={keys.n}, vals n={vals.n}")
    if keys.scheme not in ("dict", "cascade", "strdict"):
        _codes_device_column(keys)  # raises the explanatory ValueError
    if vals is not None:
        _check_supported(vals)
    bitmap = _and_validity(None if bitmap is None else bitmap.to(device), device, keys, vals)

    d = keys.params["dict_size"]
    vdt = np_dtype(vals.dtype) if vals is not None else None
    want_sum = "sum" in aggs
    want_minmax = ("min" in aggs) or ("max" in aggs)
    res = GroupResult(keys=key_values(keys), count=None)

    if vals is not None and vals.scheme == "wide":
        from . import wide

        res.count = _group_count(keys, bitmap, d, device)
        if want_sum and vdt.kind == "f":
            res.sum = _host_group_sum_float(_codes_host(keys, device), _host_decoded(vals, device), d,
                                            _host_mask(keys.n, bitmap))
        elif want_sum:
            lo_s = _run_device(keys, wide._sub(vals, "lo"), bitmap, device, want_count=False, want_sum=True,
                               want_minmax=False)["sum"][:d]
            hi_plane = wide._sub(vals, "hi")
            if vdt.kind == "i":  # the hi plane sums in the logical signedness
                hi_plane = dataclasses.replace(hi_plane, dtype="int32")
            hi_s = _run_device(keys, hi_plane, bitmap, device, want_count=False, want_sum=True,
                               want_minmax=False)["sum"][:d]
            res.sum = np.array([int(lo) + (int(hi) << 32) for lo, hi in zip(lo_s, hi_s)], dtype=object)
        if want_minmax:
            seg = _segments(keys, bitmap, device)
            k = _wide_keys(wide.decode_device(vals, device=device, pad=True).view(torch.int64), vdt.kind)
            for a in ("min", "max"):
                if a in aggs:
                    ext = _bucket_extreme(seg, k, d, a)[:d].cpu().numpy()
                    setattr(res, a, _unmap_wide_keys_host(ext, vals.dtype))
        return res

    out = _run_device(keys, vals if need_vals else None, bitmap, device, want_count=True,
                      want_sum=want_sum and vdt is not None and vdt.kind != "f", want_minmax=want_minmax)
    res.count = out["count"][:d].astype(np.int64)
    if vals is not None and want_sum:
        if vdt.kind == "f":
            res.sum = _host_group_sum_float(_codes_host(keys, device), _host_decoded(vals, device), d,
                                            _host_mask(keys.n, bitmap))
        else:
            res.sum = out["sum"][:d]
    if vals is not None and want_minmax:
        if "min" in aggs:
            res.min = _unmap_keys_host(out["min"][:d], vals.dtype)
        if "max" in aggs:
            res.max = _unmap_keys_host(out["max"][:d], vals.dtype)
    return res


def _group_count(keys, bitmap, d, device) -> np.ndarray:
    out = _run_device(keys, None, bitmap, device, want_count=True, want_sum=False, want_minmax=False)
    return out["count"][:d].astype(np.int64)


def group_count(keys: EncodedColumn, bitmap=None, *, device: torch.device | str = "cuda") -> GroupResult:
    """Value-less GROUP BY: per-key row counts (optionally filtered)."""
    return group_reduce(keys, None, ("count",), bitmap, device=device)


def group_reduce_multi(
    key_cols: list,
    vals: EncodedColumn | None = None,
    aggs: tuple[str, ...] = ("count",),
    bitmap=None,
    *,
    device: torch.device | str = "cuda",
) -> GroupResult:
    """GROUP BY several dictionary-backed key columns at once. The
    composite key is built on the host from the columns' codes (decoded on
    ``device``): np.unique over the present combinations only, then the
    single-key pass runs over a synthetic dict column. ``keys`` is an
    object array of per-column key tuples; rows null in any key drop out."""
    from . import nulls
    from .api import _decode_device
    from .api import encode as _encode
    from .util import sorted_factorize

    device = _decode_device(device)
    if not key_cols:
        raise ValueError("group_reduce_multi needs at least one key column")
    if len(key_cols) == 1:
        return group_reduce(key_cols[0], vals, aggs, bitmap, device=device)
    n = key_cols[0].n
    for k in key_cols:
        if k.n != n:
            raise ValueError("key columns must share n")
    combined = np.zeros(n, dtype=np.int64)
    dims, kvs = [], []
    for k in key_cols:
        kv = key_values(k)
        combined = combined * int(kv.shape[0]) + _codes_host(k, device)
        dims.append(int(kv.shape[0]))
        kvs.append(kv)
    # factorize over rows valid in every key: canonical fills can form
    # combinations that no valid row has, which would surface as phantom
    # groups
    valid = np.ones(n, bool)
    for k in key_cols:
        if nulls.is_nullable(k):
            valid &= nulls.valid_mask(k)
    if valid.all() or not valid.any():
        uniq, inv = sorted_factorize(combined)
    else:
        uniq, inv_v = sorted_factorize(combined[valid])
        inv = np.zeros(n, np.int64)  # null rows park on code 0; the
        inv[valid] = inv_v  # validity words below drop them
    key_col = _encode(inv.astype(np.int32), "dict")
    bitmap = _and_validity(None if bitmap is None else bitmap.to(device), device, *key_cols)
    r = group_reduce(key_col, vals, aggs, bitmap, device=device)
    out_keys = np.empty(uniq.shape[0], dtype=object)
    for j, u in enumerate(uniq):
        parts = []
        rem = int(u)
        for d in reversed(dims):
            parts.append(rem % d)
            rem //= d
        parts.reverse()
        out_keys[j] = tuple(kv[p] for kv, p in zip(kvs, parts))
    return GroupResult(keys=out_keys, count=r.count, sum=r.sum, min=r.min, max=r.max)
