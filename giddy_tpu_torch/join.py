"""Equi-joins over encoded columns: the step past ``Table.semi_join``.

Counterpart of giddy_tpu/join.py, in two parts as there:

1. **The prune on the card**: membership bitmaps both ways, left rows
   whose key is among the right's distinct keys, then right rows whose key
   is among the *surviving* left keys. These are the scan layer's isin
   paths: dictionary-domain rewrites for dict/strdict keys (K16 over the
   codes), a decode kernel and ``torch.searchsorted`` for large sets.
2. **The pair match on the host**: a sort-merge over the surviving keys
   in NumPy, whose output is materialized anyway.

Pairs are left-major: ordered by ``li``, and one left row's right
partners in original right order; outer rows follow the left-major block.
Floats match on bit patterns (-0.0 does not join +0.0; NaNs join equal
payloads), and null keys never match. With ``mesh=`` both prunes run shard
by shard over a device mesh (dist_query.isin_bitmap_sharded), the O(n) part
of a join scaling with the decode.
"""

from __future__ import annotations

import numpy as np
import torch

from .format import EncodedColumn
from .table import Table, _bitmap_indices, _distinct_values


def _match_bitmap(col: EncodedColumn, values, device: torch.device | str, mesh=None) -> torch.Tensor:
    """Null-aware membership bitmap of ``col`` in ``values`` on ``device``
    (dictionary-backed columns rewrite over their dictionary). With a mesh
    the scan runs sharded (dist_query), its bitmap on the mesh's first
    device."""
    if mesh is not None:
        from .dist_query import isin_bitmap_sharded

        if col.scheme == "strdict":
            from .groupby import _codes_device_column
            from .strings import code_set

            return isin_bitmap_sharded(_codes_device_column(col), code_set(col, values), mesh)
        return isin_bitmap_sharded(col, values, mesh)
    if col.scheme == "strdict":
        from .strings import isin_bitmap_str

        return isin_bitmap_str(col, list(values), device=device)
    from .util import np_dtype

    if col.scheme in ("dict", "cascade") and np_dtype(col.dtype).kind != "f":
        from .groupby import key_values
        from .query import dict_mask_bitmap

        kv = key_values(col)
        want = set(int(v) for v in values)
        mask = np.fromiter((int(v) in want for v in kv), bool, count=kv.shape[0])
        return dict_mask_bitmap(col, mask, device=device)
    from .query import isin_bitmap

    return isin_bitmap(col, list(values), device=device)


def _take_keys(col: EncodedColumn, idx: np.ndarray, device: torch.device | str) -> np.ndarray:
    """Key values at ``idx`` in a sort/searchsorted-friendly dtype
    (strings come back as fixed-width bytes)."""
    k = Table([col], device=device).take(col.name, idx)
    if k.dtype == object:  # str/bytes objects from a string dictionary
        from .strings import as_bytes

        # fixed-width "S" treats trailing NULs as padding, which would alias
        # b"a" and b"a\x00"; a \x01 sentinel suffix keeps every key's NULs
        # interior (stripped again before the device probe)
        k = np.array([as_bytes(x) + b"\x01" for x in k], dtype=np.bytes_)
    return k


def _common_key_dtype(a: np.ndarray, b: np.ndarray):
    if a.dtype.kind == "S" or b.dtype.kind == "S":
        if a.dtype.kind != b.dtype.kind:
            raise TypeError(f"cannot join string keys with numeric keys ({a.dtype} vs {b.dtype})")
        return None  # bytes compare fine at mixed widths
    ct = np.promote_types(a.dtype, b.dtype)
    if ct.kind == "f" and a.dtype.kind != "f" and b.dtype.kind != "f":
        raise TypeError(f"no exact common integer type for join keys {a.dtype} vs {b.dtype}")
    return ct


def join_indices(left: EncodedColumn, right: EncodedColumn, *, mesh=None, how: str = "inner",
                 device: torch.device | str = "cuda"):
    """Row-index pairs (li, ri), int64 NumPy, of the equi-join ``left ==
    right``, the prunes on ``device``, or sharded over ``mesh``.
    ``how="left"`` also emits every unmatched left row (null keys
    included) once with ``ri = -1``; ``how="outer"`` also appends every
    unmatched right row once with ``li = -1``, after the left-major block."""
    if how not in ("inner", "left", "outer"):
        raise ValueError(f"how must be 'inner', 'left' or 'outer', got {how!r}")
    li, ri = _inner_indices(left, right, device, mesh)
    if how == "inner":
        return li, ri
    unmatched = np.setdiff1d(np.arange(left.n, dtype=np.int64), li)
    li_all = np.concatenate([li, unmatched])
    ri_all = np.concatenate([ri, np.full(unmatched.size, -1, np.int64)])
    order = np.argsort(li_all, kind="stable")
    li_all, ri_all = li_all[order], ri_all[order]
    if how == "outer":
        r_un = np.setdiff1d(np.arange(right.n, dtype=np.int64), ri)
        li_all = np.concatenate([li_all, np.full(r_un.size, -1, np.int64)])
        ri_all = np.concatenate([ri_all, r_un])
    return li_all, ri_all


def _inner_indices(left: EncodedColumn, right: EncodedColumn, device: torch.device | str, mesh=None):
    right_set = _distinct_values(right, device)
    if not right_set:
        e = np.empty(0, np.int64)
        return e, e
    li = _bitmap_indices(_match_bitmap(left, right_set, device, mesh), left.n)
    if li.size == 0:
        return li, np.empty(0, np.int64)
    lk = _take_keys(left, li, device)
    # prune the right side with the keys that survived the left scan
    if lk.dtype.kind == "f":
        # distinct and probe in bit-pattern space (the device scan's)
        w = np.unique(lk.view(np.uint32 if lk.dtype.itemsize == 4 else np.uint64))
        probe_vals = [float(x) for x in w.view(lk.dtype)]
    elif lk.dtype.kind == "S":
        probe_vals = [bytes(v)[:-1] for v in np.unique(lk)]  # the \x01 sentinel off
    else:
        probe_vals = [int(v) for v in np.unique(lk)]
    ri = _bitmap_indices(_match_bitmap(right, probe_vals, device, mesh), right.n)
    if ri.size == 0:
        return np.empty(0, np.int64), ri
    rk = _take_keys(right, ri, device)
    ct = _common_key_dtype(lk, rk)
    if ct is not None:
        lk = lk.astype(ct)
        rk = rk.astype(ct)
    if lk.dtype.kind == "f":
        # pair-match on bit patterns, so host equality == device equality
        u = np.uint32 if lk.dtype.itemsize == 4 else np.uint64
        lk, rk = lk.view(u), rk.view(u)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        e = np.empty(0, np.int64)
        return e, e
    starts = np.repeat(lo, counts)
    base = np.cumsum(counts) - counts
    offs = np.arange(total, dtype=np.int64) - np.repeat(base, counts)
    return np.repeat(li, counts), ri[order[starts + offs]]


def anti_join_bitmap(probe: EncodedColumn, build: EncodedColumn, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """LMP(1) bitmap, on ``device``, of probe rows with a non-null key that
    has NO match in ``build`` (NOT EXISTS): the complement of the
    semi-join restricted to valid rows."""
    from . import nulls
    from .api import _decode_device
    from .query import _zeros, bitmap_not

    device = _decode_device(device)
    build_set = _distinct_values(build, device)
    if not build_set:
        if nulls.is_nullable(probe):
            return nulls.valid_words_device(probe, device).clone()
        return bitmap_not(_zeros(probe, device), probe.n)  # every row has no partner
    bm = bitmap_not(_match_bitmap(probe, build_set, device), probe.n)
    if nulls.is_nullable(probe):
        bm = bm & nulls.valid_words_device(probe, device)
    return bm


def join_tables(left: Table, on: str, right: Table, right_on: str | None = None,
                select=None, right_select=None, suffix: str = "_r", *, mesh=None, how: str = "inner"):
    """Materialized equi-join of two Tables, on the left Table's device.

    Returns ``(rows, li, ri)``: a dict of joined output columns (left
    ``select`` names as they are; right ``right_select`` names, suffixed on
    collision) and the row-index pairs. ``select`` defaults to all left
    columns, ``right_select`` to all right columns but the key. Unmatched
    outer cells hold placeholder values: mask with ``ri >= 0`` (left join)
    or ``li >= 0`` (right-only rows of an outer join). ``mesh``: the
    prunes run sharded over it."""
    right_on = on if right_on is None else right_on
    li, ri = join_indices(left[on], right[right_on], mesh=mesh, how=how, device=left.device)
    select = left.names if select is None else list(select)
    if right_select is None:
        right_select = [nm for nm in right.names if nm != right_on]
    rows: dict[str, np.ndarray] = {}
    for nm in select:
        rows[nm] = _take_placeholder(left, nm, li)
    for nm in right_select:
        out = nm if nm not in rows else nm + suffix
        if out in rows:
            raise ValueError(f"column name collision after suffix: {out!r}")
        rows[out] = _take_placeholder(right, nm, ri)
    return rows, li, ri


def _take_placeholder(tbl: Table, nm: str, idx: np.ndarray) -> np.ndarray:
    """Rows at ``idx`` where -1 slots (outer-join placeholders) read row 0,
    or a zero value when the table is empty."""
    if tbl.n == 0:
        e = tbl.take(nm, np.empty(0, np.int64))
        return np.zeros(idx.shape[0], dtype=e.dtype)
    return tbl.take(nm, np.where(idx < 0, 0, idx))


def _take_valid(tbl: Table, nm: str, idx: np.ndarray) -> np.ndarray:
    """Validity of rows at ``idx``: False at -1 placeholder slots AND at
    source rows that are themselves null (SQL null propagation)."""
    from . import nulls

    valid = idx >= 0
    if tbl.n == 0:  # all-placeholder side: no row 0 to probe
        return valid
    col = tbl[nm]
    if nulls.is_nullable(col):
        valid = valid & nulls.valid_mask(col)[np.where(idx < 0, 0, idx)]
    return valid


def join_table(left: Table, on: str, right: Table, right_on: str | None = None,
               select=None, right_select=None, suffix: str = "_r", *,
               mesh=None, how: str = "inner", schemes=None) -> Table:
    """Materialized equi-join as an encoded Table on the left Table's
    device: unmatched outer cells, and source nulls, are encoded NULL rows
    (validity bitmaps), so the result round-trips through the container.
    ``schemes`` pins encode schemes per output column (advisor otherwise)."""
    right_on = on if right_on is None else right_on
    li, ri = join_indices(left[on], right[right_on], mesh=mesh, how=how, device=left.device)
    select = left.names if select is None else list(select)
    if right_select is None:
        right_select = [nm for nm in right.names if nm != right_on]
    arrays: dict = {}

    def put(tbl: Table, nm: str, out: str, idx: np.ndarray) -> None:
        if out in arrays:
            raise ValueError(f"column name collision after suffix: {out!r}")
        v = _take_placeholder(tbl, nm, idx)
        valid = _take_valid(tbl, nm, idx)
        arrays[out] = v if valid.all() else (v, valid)

    for nm in select:
        put(left, nm, nm, li)
    for nm in right_select:
        put(right, nm, nm if nm not in arrays else nm + suffix, ri)
    return Table.from_arrays(arrays, schemes, device=left.device)
