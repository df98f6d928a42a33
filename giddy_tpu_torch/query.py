"""Predicate pushdown on the GPU: decode-and-filter in one fused kernel.

Counterpart of giddy_tpu/query.py. A scan evaluates its predicate inside
the decode: for nbit, dzbf and for the kernel K16 (kernels/filter_.py)
reads the packed words and writes a 1-bit LMP(1) bitmap, 1/32 of the
decoded bytes; for rle and rpe in the tile form K19
(kernels/run_filter.py) compares each run once and writes the bitmap
from the run tables; every other scheme decodes with its own kernel and
compares in torch ops on the card. The comparison value is a kernel
argument, staged on the host.

Comparisons follow the column's logical dtype: narrow signed payloads
sign-extend, floats compare in IEEE total order (-0.0 < +0.0 and unequal
to it; NaNs at the extremes). Nullable columns AND their validity words
in: NULL never matches. Dictionary-backed columns (dict, cascade) push the
predicate into the dictionary on the host and scan code ranges with K16
over the code column.

64-bit (wide) columns decode both 32-bit planes with their kernels and
compare with 64-bit semantics pieced from the halves (``_wide_hits``);
``isin_bitmap`` searches their (hi, lo) pairs. ``select``/``select_where``
decode only the groups that hold matches (partial.take).

Every entry point takes ``device``, the card unless the caller asks for
``"cpu"``, and returns tensors on it. Bitmaps are (ng, LANES) int32
tensors carrying the uint32 words; bits past n are whatever the compare
gives, and ``count_bits`` masks them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nulls
from .api import _check_supported, _decode_device, device_streams, get_decoder
from .format import EncodedColumn
from .kernels import lanes
from .kernels.filter_ import OPS, filter_fold
from .kernels.run_filter import run_filter
from .ref.lmp import lmp_unpack
from .util import GROUP, LANES, NP_CMP, SLOTS, check_device_addressable, np_dtype, num_groups

# Schemes that K16 scans from their packed words.
FUSED = ("nbit", "dzbf", "for")
# Schemes that K19 scans from their run tables, in the tile form (the
# scatter form, runs too dense for tiles, takes the general path).
RUN_TABLES = ("rle", "rpe")


def _host_key_u32(u: np.ndarray) -> np.ndarray:
    """IEEE-754 bit patterns -> monotone uint32 keys (flip all bits of
    negatives, only the sign bit of non-negatives), giddy_tpu/query.py:175."""
    u = u.astype(np.uint32)
    neg = np.where(u >> np.uint32(31), np.uint32(0xFFFFFFFF), np.uint32(0))
    return u ^ (np.uint32(0x80000000) | neg)


def host_cmp_mask(u: np.ndarray, op: str, value, dtype: str) -> np.ndarray:
    """Host twin of the device compare: uint32 payloads vs a scalar, with
    the semantics of _cmp + _stage_value (mod-2^32 staging of out-of-range
    ints, sign-extension of narrow payloads, float total order)."""
    dt = np_dtype(dtype)
    u = u.view(np.uint32)
    if dt.kind == "f":
        keys = _host_key_u32(u)
        cval = _host_key_u32(np.float32(value).view(np.uint32).reshape(1))[0]
    elif dt.kind == "i":
        k = 32 - 8 * dt.itemsize
        keys = (u.view(np.int32) << k) >> k if k else u.view(np.int32)
        cval = np.array(value, np.int64).astype(np.uint32).view(np.int32)
    else:
        keys = u
        cval = np.array(value, np.int64).astype(np.uint32)
    return NP_CMP[op](keys, cval)


def _stage_value(dtype: str, value) -> np.ndarray:
    """The (1, 1) comparison value of giddy_tpu/query.py:243: int32 for
    signed columns (wrap-exact via int64 staging), total-order uint32 for
    floats, raw uint32 otherwise."""
    dk = np_dtype(dtype).kind
    if dk == "f":
        return _host_key_u32(np.float32(value).view(np.uint32).reshape(1, 1))
    ctype = np.int32 if dk == "i" else np.uint32
    return np.array([[value]], dtype=np.int64).astype(np.uint32).view(ctype)


def _stage_value_wide(dtype: str, value) -> tuple[int, int]:
    """64-bit staging (giddy_tpu/query.py:256): the (lo, hi) uint32 halves,
    floats pre-mapped to the 64-bit total-order key."""
    dk = np_dtype(dtype).kind
    dt = {"i": np.int64, "u": np.uint64, "f": np.float64}[dk]
    u = np.array(value, dtype=dt).view(np.uint64)
    if dk == "f":
        neg = np.uint64(0xFFFFFFFFFFFFFFFF) if (u >> np.uint64(63)) else np.uint64(0)
        u = u ^ (np.uint64(0x8000000000000000) | neg)
    return int(u & np.uint64(0xFFFFFFFF)), int(u >> np.uint64(32))


def _i32(x: int) -> int:
    """A uint32 as the int32 that carries its bits."""
    return x - (1 << 32) if x >= 1 << 31 else x


def _wide_hits(lo: torch.Tensor, hi: torch.Tensor, clo: int, chi: int, kind: str, op: str) -> torch.Tensor:
    """64-bit compare pieced from the int32-carried (lo, hi) planes
    (giddy_tpu/query.py:129): hi ordered in the logical signedness (floats
    through the total-order key: all 64 bits of negatives flipped, only the
    sign bit of non-negatives; the value's halves arrive pre-mapped), lo
    always unsigned. Unsigned order compares ``x ^ 0x80000000`` as int32."""
    if kind == "f":
        neg = hi >> 31  # arithmetic: all ones for negatives
        hi = hi ^ (neg | -(2**31))
        lo = lo ^ neg
    flip = 0 if kind == "i" else -(2**31)
    hi_o, chi_o = hi ^ flip, _i32(chi) ^ flip
    lo_o, clo_o = lo ^ -(2**31), _i32(clo) ^ -(2**31)
    eq = (hi == _i32(chi)) & (lo == _i32(clo))
    lt = (hi_o < chi_o) | ((hi == _i32(chi)) & (lo_o < clo_o))
    return {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt}[op]


def _stage_key(dtype: str, value) -> int:
    """The staged value as an order key (lanes.order_key), the int32 that
    K16 takes as its kernel argument: signed values as they are, uint32
    and total-order keys with the sign bit flipped."""
    staged = _stage_value(dtype, value).view(np.uint32)
    if np_dtype(dtype).kind != "i":
        staged = staged ^ np.uint32(0x80000000)
    return int(staged.view(np.int32)[0, 0])


def _cmp(v: torch.Tensor, key: int, op: str, kind: str, itemsize: int) -> torch.Tensor:
    """Compare int32-carried uint32 payloads with a staged value in
    logical-dtype semantics (giddy_tpu/query.py:51-69), on order keys."""
    return lanes.CMP[op](lanes.order_key(v, kind, itemsize), key)


def _zeros(col: EncodedColumn, device: torch.device) -> torch.Tensor:
    return torch.zeros((num_groups(col.n), LANES), dtype=torch.int32, device=device)


def _dict_code_ranges(col: EncodedColumn, op: str, value) -> list[tuple[int, int]] | None:
    """The predicate over the DICTIONARY (host, O(dict_size)) as contiguous
    [start, end) code ranges; None when more than 4 ranges match, where
    one decode + compare beats the OR of range scans."""
    mask = host_cmp_mask(col.streams["values"].view(np.uint32), op, value, col.dtype)
    bounds = np.flatnonzero(np.diff(mask.astype(np.int8), prepend=0, append=0))
    ranges = list(zip(bounds[0::2].tolist(), bounds[1::2].tolist()))
    return ranges if len(ranges) <= 4 else None


def _code_streams(col: EncodedColumn, streams: dict | None) -> dict | None:
    """The code column's device streams within a dict/cascade column's."""
    if streams is None:
        return None
    if col.scheme == "dict":
        return {"packed": streams["codes"]}
    return {k[2:]: v for k, v in streams.items() if k.startswith("c_")}


def _dict_filter_bitmap(col: EncodedColumn, op: str, value, device: torch.device,
                        streams: dict | None = None) -> torch.Tensor | None:
    """filter_bitmap for dict/cascade columns via code range scans (K16
    over the code column where its scheme is fused)."""
    from .groupby import _codes_device_column

    ranges = _dict_code_ranges(col, op, value)
    if ranges is None:
        return None  # the caller falls back to decode + compare
    inner, inner_streams = _codes_device_column(col), _code_streams(col, streams)
    acc = None
    for s, e in ranges:
        if e - s == 1:
            bm = filter_bitmap(inner, "eq", s, device=device, streams=inner_streams)
        elif s == 0:
            bm = filter_bitmap(inner, "lt", e, device=device, streams=inner_streams)
        elif e == col.params["dict_size"]:
            bm = filter_bitmap(inner, "ge", s, device=device, streams=inner_streams)
        else:
            bm = between_bitmap(inner, s, e - 1, device=device, streams=inner_streams)
        acc = bm if acc is None else acc | bm
    return _zeros(col, device) if acc is None else acc


def filter_bitmap(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda",
                  streams: dict | None = None) -> torch.Tensor:
    """(ng, LANES) int32 bitmap words in LMP(1) layout: bit i of word
    [g, c] = predicate(col[g*GROUP + i*LANES + c]). Pad positions past n
    are garbage; count_where masks them. ``streams``: the column's streams
    already on ``device`` in device form (a partial.GroupSlicer slice's,
    which skip the registry's prep); uploaded here when None."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    device = _decode_device(device)
    check_device_addressable(col.n, f"scan of {col.name!r}")
    _check_supported(col)
    valid = None
    if nulls.is_nullable(col):
        valid = streams["valid"] if streams is not None and "valid" in streams else nulls.valid_words_device(col, device)
    if col.scheme in ("cascade", "dict"):
        bm = _dict_filter_bitmap(col, op, value, device, streams)
        if bm is not None:
            return bm if valid is None else bm & valid
        # fragmented match set: fall through to decode + compare
    dt = np_dtype(col.dtype)
    if col.scheme == "wide":
        from . import wide

        lo, hi = wide.plane_payloads(col, device)
        ng = num_groups(col.n)
        bm = lanes.pack_hits(_wide_hits(lo.view(ng, GROUP), hi.view(ng, GROUP),
                                        *_stage_value_wide(col.dtype, value), dt.kind, op))
        return bm if valid is None else bm & valid
    key = _stage_key(col.dtype, value)
    if streams is None:
        streams = device_streams(col, device)
    if col.scheme in FUSED:  # one launch, the validity AND included
        bits = col.params["bits"] if col.scheme != "dzbf" else 8 * col.params["width"]
        return filter_fold(streams["packed"], streams.get("refs_g"), valid, bits, dt.kind, dt.itemsize, op, key)
    if col.scheme in RUN_TABLES and "vals_w" in streams:  # the tile form: one launch on the runs
        w_pad = streams["vals_w"].shape[-1]
        return run_filter(streams["ends_w"].reshape(-1, w_pad), streams["vals_w"].reshape(-1, w_pad), valid,
                          num_groups(col.n), dt.kind, dt.itemsize, op, key)
    u = get_decoder(col)(streams).view(num_groups(col.n), GROUP)
    bm = lanes.pack_hits(_cmp(u, key, op, dt.kind, dt.itemsize))
    return bm if valid is None else bm & valid


def _tail_mask(n: int) -> np.ndarray:
    """(LANES,) uint32 valid-bit words for the LAST group only; all earlier
    groups are fully valid."""
    base = (num_groups(n) - 1) * GROUP
    i = np.arange(SLOTS)[:, None]
    c = np.arange(LANES)[None, :]
    valid = (base + i * LANES + c) < n
    return (valid.astype(np.uint32) << np.arange(SLOTS, dtype=np.uint32)[:, None]).sum(0, dtype=np.uint32)


def _mask_pad(words: torch.Tensor, n: int) -> torch.Tensor:
    """Zero the bits of pad positions (only the final group can hold any)."""
    ng = num_groups(n)
    if n < ng * GROUP:
        words = words.clone()
        words[ng - 1] &= torch.from_numpy(_tail_mask(n).view(np.int32)).to(words.device)
    return words


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each int32-carried uint32 word (int64 counts)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def count_bits(words: torch.Tensor, n: int) -> int:
    """Population count of an LMP(1) bitmap over a column of n elements
    (pad bits masked)."""
    return int(popcount_words(_mask_pad(words, n)).sum().item())


def count_where(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda") -> int:
    """Number of elements satisfying the predicate; 0, with no launch, for
    an empty column."""
    if col.n == 0:
        if op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
        _decode_device(device)
        return 0
    return count_bits(filter_bitmap(col, op, value, device=device), col.n)


# --- bitmap algebra -------------------------------------------------------
# Predicates compose on the 1-bit bitmaps, never on decoded values; all of
# these stay on the bitmaps' device.


def bitmap_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def bitmap_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def bitmap_not(words: torch.Tensor, n: int) -> torch.Tensor:
    """Complement within the column (pad bits forced to 0). SQL NOT over a
    nullable column's predicate must also exclude the nulls: AND the result
    with nulls.notnull_bitmap(col)."""
    return _mask_pad(~words, n)


def between_bitmap(col: EncodedColumn, lo, hi, *, device: torch.device | str = "cuda",
                   streams: dict | None = None) -> torch.Tensor:
    """Bitmap of lo <= col[i] <= hi (inclusive both ends); ``streams`` as
    in filter_bitmap."""
    return bitmap_and(filter_bitmap(col, "ge", lo, device=device, streams=streams),
                      filter_bitmap(col, "le", hi, device=device, streams=streams))


def count_between(col: EncodedColumn, lo, hi, *, device: torch.device | str = "cuda") -> int:
    return count_bits(between_bitmap(col, lo, hi, device=device), col.n)


def isin_bitmap(col: EncodedColumn, values, *, device: torch.device | str = "cuda",
                streams: dict | None = None) -> torch.Tensor:
    """Bitmap of membership in a value set. Up to 8 values OR eq scans;
    larger sets run one binary search of each decoded payload in the
    sorted staged set; wide columns always search their (hi, lo) pairs.
    Floats match in bit-pattern space (-0.0 does not match +0.0; NaNs
    match equal-payload NaNs). ``streams`` as in filter_bitmap (32-bit
    columns)."""
    device = _decode_device(device)
    _check_supported(col)
    if col.scheme == "wide":
        return _isin_searched_wide(col, values, device)
    return isin_apply(col, isin_terms(col, values), device, streams)


def isin_terms(col: EncodedColumn, values):
    """A 32-bit column's membership set as isin_bitmap scans it, staged on
    the host once: ("eq", up to 8 scalars) for an OR of eq scans,
    ("search", the _staged_set_u32 table) beyond, None for an empty set."""
    dt = np_dtype(col.dtype)
    if dt.kind == "f":
        fv = np.asarray(np.asarray(values, dtype=object).reshape(-1), np.float32)
        u, ix = np.unique(fv.view(np.uint32), return_index=True)
        if u.size == 0:
            return None
        if u.size > 8:
            return "search", _staged_set_u32(col.dtype, [int(x) for x in u])
        # the float32 scalars themselves: a Python float would quiet a
        # signaling NaN, unlike the searched path's raw bit patterns
        return "eq", [fv[i] for i in np.sort(ix)]
    vals = list(dict.fromkeys(int(v) for v in np.asarray(values).reshape(-1)))
    if dt.itemsize < 4 and vals:
        # drop values the logical dtype cannot represent -- the rule of
        # _staged_set_u32, so both set sizes give the same membership
        bits = 8 * dt.itemsize
        lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if dt.kind == "i" else (0, (1 << bits) - 1)
        vals = [v for v in vals if lo <= v <= hi]
    if not vals:
        return None
    if len(vals) > 8:
        return "search", _staged_set_u32(col.dtype, vals)
    return "eq", vals


def isin_apply(col: EncodedColumn, terms, device: torch.device, streams: dict | None = None,
               table: torch.Tensor | None = None) -> torch.Tensor:
    """The membership bitmap of isin_terms' set on ``device``; ``table``:
    the search table already there (int64, as _isin_searched uploads it)."""
    if terms is None:
        return _zeros(col, device)
    kind, x = terms
    if kind == "search":
        return _isin_searched(col, x, device, streams, table)
    acc = None
    for v in x:
        bm = filter_bitmap(col, "eq", v, device=device, streams=streams)
        acc = bm if acc is None else acc | bm
    return acc


def _staged_set_u32(dtype: str, vals) -> np.ndarray | None:
    """Host-stage an integer value set for a 32-bit payload search
    (giddy_tpu/query.py:451): narrow dtypes drop unrepresentable values,
    values are masked to the payload width, sorted, deduped and padded to
    a power of two by repeating the maximum. None = provably empty."""
    dt = np_dtype(dtype)
    bits = 8 * dt.itemsize
    if bits < 32:
        lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if dt.kind == "i" else (0, (1 << bits) - 1)
        vals = [v for v in vals if lo <= v <= hi]
        if not vals:
            return None
    staged = np.unique((np.array(vals, dtype=np.int64) & ((1 << bits) - 1)).astype(np.uint32))
    m = 1 << (int(staged.size - 1).bit_length())
    return np.concatenate([staged, np.repeat(staged[-1:], m - staged.size)])


def _isin_searched(col: EncodedColumn, staged: np.ndarray, device: torch.device, streams: dict | None = None,
                   table: torch.Tensor | None = None) -> torch.Tensor:
    """Decode, then searchsorted of each payload into the staged set
    (_staged_set_u32). The search runs on int64 (payload & 0xFFFFFFFF): an
    int32-carried table would order payloads >= 2^31 as negatives."""
    if table is None:
        table = torch.from_numpy(staged.astype(np.int64)).to(device)
    if streams is None:
        streams = device_streams(col, device)
    u = get_decoder(col)(streams).to(torch.int64) & 0xFFFFFFFF
    pos = torch.searchsorted(table, u).clamp_(max=table.shape[0] - 1)
    bm = lanes.pack_hits((table[pos] == u).view(num_groups(col.n), GROUP))
    if not nulls.is_nullable(col):
        return bm
    return bm & (streams["valid"] if "valid" in streams else nulls.valid_words_device(col, device))


def _staged_set_u64(dtype: str, values) -> tuple[np.ndarray, np.ndarray] | None:
    """64-bit twin of _staged_set_u32 (giddy_tpu/query.py:474): (lo, hi)
    uint32 plane pairs sorted by (hi, lo), deduped, padded to a power of
    two. Floats stage as raw float64 bit patterns. None = provably empty."""
    dt = np_dtype(dtype)
    vals = np.asarray(values, dtype=object).reshape(-1)
    if dt.kind == "f":
        u = np.array([float(v) for v in vals], np.float64).view(np.uint64)
    else:
        lo_b, hi_b = (0, 2**64) if dt.kind == "u" else (-(2**63), 2**63)
        kept = [int(v) for v in vals if lo_b <= int(v) < hi_b]
        u = np.array(kept, dtype=np.int64 if dt.kind == "i" else np.uint64).view(np.uint64)
    if u.size == 0:
        return None
    slo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    shi = (u >> np.uint64(32)).astype(np.uint32)
    order = np.lexsort((slo, shi))
    slo, shi = slo[order], shi[order]
    keep = np.ones(slo.size, bool)
    keep[1:] = (slo[1:] != slo[:-1]) | (shi[1:] != shi[:-1])
    slo, shi = slo[keep], shi[keep]
    m = 1 << (int(slo.size - 1).bit_length())
    slo = np.concatenate([slo, np.repeat(slo[-1:], m - slo.size)])
    shi = np.concatenate([shi, np.repeat(shi[-1:], m - shi.size)])
    return slo, shi


def _isin_searched_wide(col: EncodedColumn, values, device: torch.device) -> torch.Tensor:
    """Membership for wide columns (giddy_tpu/query.py:532): both planes
    decode on the card and each (hi, lo) pair searches the staged set. The
    search runs on int64 keys ``(hi, lo) ^ 2^63``, whose signed order is
    the set's (hi, lo) unsigned order."""
    from . import wide

    staged = _staged_set_u64(col.dtype, values)
    if staged is None:
        return _zeros(col, device)
    bm = lanes.pack_hits(_wide_search_hits(*wide.plane_payloads(col, device), staged).view(num_groups(col.n), GROUP))
    return bm & nulls.valid_words_device(col, device) if nulls.is_nullable(col) else bm


def _wide_search_hits(lo: torch.Tensor, hi: torch.Tensor, staged: tuple[np.ndarray, np.ndarray]) -> torch.Tensor:
    """Membership of each (hi, lo) payload pair in a _staged_set_u64 set,
    searched on the planes' device."""
    from . import wide

    slo, shi = staged
    table = torch.from_numpy((slo.astype(np.uint64) | (shi.astype(np.uint64) << np.uint64(32))).view(np.int64))
    table = table.to(lo.device) ^ -(2**63)
    v = wide.combine_device(lo, hi, "int64") ^ -(2**63)
    pos = torch.searchsorted(table, v).clamp_(max=table.shape[0] - 1)
    return table[pos] == v


def dict_mask_bitmap(col: EncodedColumn, mask: np.ndarray, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """Bitmap of rows whose dictionary entry is set in ``mask`` (bool[d]),
    dict/cascade columns: up to 8 code ranges scan as range filters over
    the code column, a fragmented mask as one lookup over the decoded
    codes. The semi-join primitive."""
    from .groupby import _codes_device_column

    device = _decode_device(device)
    mask = np.asarray(mask, bool)
    d = col.params["dict_size"]
    if mask.shape != (d,):
        raise ValueError(f"mask must have shape ({d},), got {mask.shape}")
    inner = _codes_device_column(col)
    bounds = np.flatnonzero(np.diff(mask.astype(np.int8), prepend=0, append=0))
    ranges = list(zip(bounds[0::2].tolist(), bounds[1::2].tolist()))
    if len(ranges) <= 8:
        acc = _zeros(col, device)
        for s, e in ranges:
            acc = acc | (filter_bitmap(inner, "eq", s, device=device) if e - s == 1
                         else between_bitmap(inner, s, e - 1, device=device))
    else:
        codes = get_decoder(inner)(device_streams(inner, device)).view(num_groups(col.n), GROUP)
        acc = lanes.pack_hits(lanes.gather(torch.from_numpy(mask).to(device), codes))
    return acc & nulls.valid_words_device(col, device) if nulls.is_nullable(col) else acc


def filter_bitmap_cols(a: EncodedColumn, b: EncodedColumn, op: str, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """Column-vs-column predicate: bitmap of ``a[i] <op> b[i]``. Both
    columns decode on the card and compare on the same order keys. They
    must share length and logical dtype; 64-bit columns are not taken."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if a.n != b.n:
        raise ValueError(f"length mismatch: {a.n} vs {b.n}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if "wide" in (a.scheme, b.scheme):
        raise NotImplementedError("column-vs-column compare of 64-bit columns")
    device = _decode_device(device)
    dt = np_dtype(a.dtype)
    ka, kb = (lanes.order_key(get_decoder(c)(device_streams(c, device)), dt.kind, dt.itemsize) for c in (a, b))
    bm = lanes.pack_hits(lanes.CMP[op](ka, kb).view(num_groups(a.n), GROUP))
    for c in (a, b):  # SQL: a row with either side NULL never matches
        if nulls.is_nullable(c):
            bm = bm & nulls.valid_words_device(c, device)
    return bm


def count_where_cols(a: EncodedColumn, b: EncodedColumn, op: str, *, device: torch.device | str = "cuda") -> int:
    """Number of rows where ``a[i] <op> b[i]``."""
    return count_bits(filter_bitmap_cols(a, b, op, device=device), a.n)


def select(col: EncodedColumn, bitmap: torch.Tensor, *, device: torch.device | str = "cuda") -> np.ndarray:
    """The values at the bitmap's set positions, the SELECT half of a scan
    (the bitmap from filter_bitmap over this or any column of the same
    length). Only the groups that hold matches decode, on ``device``
    (partial.take); the result is NumPy."""
    from .partial import take

    words = bitmap.cpu().numpy().view(np.uint32).reshape(num_groups(col.n), LANES)
    mask = lmp_unpack(words, 1, col.n).astype(bool)
    return take(col, np.flatnonzero(mask), device=device)


def select_where(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda") -> np.ndarray:
    """One-shot ``SELECT col WHERE col <op> value``."""
    return select(col, filter_bitmap(col, op, value, device=device), device=device)


def where_mask(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda") -> np.ndarray:
    """Boolean mask of length n (host), the unpacked bitmap, for checks and
    small results; big pipelines consume the bitmap itself."""
    words = filter_bitmap(col, op, value, device=device).cpu().numpy().view(np.uint32)
    return lmp_unpack(words, 1, col.n).astype(bool)
