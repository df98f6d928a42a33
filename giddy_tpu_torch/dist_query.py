"""Sharded scans: predicate pushdown, aggregates and GROUP BY over a mesh.

Counterpart of giddy_tpu/dist_query.py. Each shard of a column (dist.py:
a partial.GroupSlicer slice on its mesh position's device) runs the
single-GPU scan on its own streams: query.filter_bitmap (K16 over nbit,
dzbf and for words and over dict codes, the decode kernel and a compare on
the card otherwise), aggregate._run (K17, or the decode kernel and the
slot fold) and the GROUP BY fold of groupby.py. Every fold stays on its
shard; what crosses shards is the result: the (ng, LANES) match words where
a whole bitmap is returned, and otherwise scalar counts, sums and extremes
(or a GROUP BY's O(dict_size) partials), combined exactly on the host and,
on a mesh that spans processes, all-reduced (dist.all_reduce).

Pad positions never count: a shard's slice holds only real rows, the match
words of the last real group keep their pad bits zero, and shards made of
pad groups alone take no part. Exactness is the single-GPU layer's: integer
sums in int64 partials and Python ints, float sums in float64 on the host,
min/max on order keys; 64-bit (wide) columns compose per 32-bit plane
(sums, counts) or answer from their zone maps (min/max).

Entry points take the reference's ``mesh`` (default dist.default_mesh) and
``axis``; whole bitmaps come back on the mesh's first device.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from . import nulls
from .dist import Mesh, Shard, all_reduce, decode_shard, default_mesh, place
from .format import EncodedColumn
from .kernels.filter_ import OPS
from .util import GROUP, LANES, check_device_addressable, np_dtype, num_groups

# Placed shards, keyed by column identity and mesh (static keys alone would
# alias distinct columns of equal shapes): a bounded LRU whose entries hold
# the column, so that a reused id() cannot alias a new one. Derived columns
# (wide planes, key codes) are memoized on their parents, so repeats hit.
_ARGS_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_ARGS_CACHE_MAX = 64


def _cache_get(key):
    hit = _ARGS_CACHE.get(key)
    if hit is not None:
        _ARGS_CACHE.move_to_end(key)
    return hit


def _cache_put(key, value) -> None:
    _ARGS_CACHE[key] = value
    _ARGS_CACHE.move_to_end(key)
    while len(_ARGS_CACHE) > _ARGS_CACHE_MAX:
        _ARGS_CACHE.popitem(last=False)


def _key(col: EncodedColumn, mesh: Mesh, axis, what: str = "") -> tuple:
    return (id(col), what, mesh.key(), axis if isinstance(axis, str) else tuple(axis))


def shards(col: EncodedColumn, mesh: Mesh, axis="d") -> list[Shard]:
    """This process's placed shards of a 32-bit column (dist.place),
    cached per (column identity, mesh): repeated scans, and the several
    folds of one GROUP BY, upload nothing again."""
    key = _key(col, mesh, axis)
    hit = _cache_get(key)
    if hit is not None and hit[0] is col:
        return hit[1]
    placed = place(col, mesh, axis)
    _cache_put(key, (col, placed))
    return placed


def _real(col: EncodedColumn, mesh: Mesh, axis) -> list[Shard]:
    return [sh for sh in shards(col, mesh, axis) if sh.col is not None]


def _valid_windows(col: EncodedColumn, mesh: Mesh, axis, plan: list[Shard]) -> list | None:
    """Each shard's window of a nullable column's validity words on its
    device (a wide column's planes do not carry them); None if the column
    is not nullable."""
    if not nulls.is_nullable(col):
        return None
    key = _key(col, mesh, axis, "valid")
    hit = _cache_get(key)
    if hit is not None and hit[0] is col:
        return hit[1]
    words = col.streams["valid"]
    out = [torch.from_numpy(np.ascontiguousarray(words[sh.g0 : sh.g1]).view(np.int32)).to(sh.device) for sh in plan]
    _cache_put(key, (col, out))
    return out


def _mesh(mesh, axis) -> Mesh:
    return mesh if mesh is not None else default_mesh(axis if isinstance(axis, str) else axis[0])


# --- per-shard match words ----------------------------------------------------


def _pairs(col: EncodedColumn, mesh: Mesh, axis) -> list[tuple[Shard, Shard]]:
    """(lo, hi) plane shards of a wide column, shard by shard."""
    from . import wide

    return list(zip(_real(wide._sub(col, "lo"), mesh, axis), _real(wide._sub(col, "hi"), mesh, axis)))


def _finish(sh: Shard, hits: torch.Tensor, valid) -> torch.Tensor:
    """A shard's hits -> its match words, the validity ANDed in and the
    bits past its real rows zero."""
    from .kernels import lanes
    from .query import _mask_pad

    words = lanes.pack_hits(hits.view(sh.g1 - sh.g0, GROUP))
    if valid is not None:
        words = words & valid
    return _mask_pad(words, sh.col.n)


def _filter_words(col: EncodedColumn, op: str, value, mesh: Mesh, axis) -> list[tuple[Shard, torch.Tensor]]:
    """Each of this process's real shards with its (g1 - g0, LANES) match
    words, pad bits zero."""
    from .query import _mask_pad, _stage_value_wide, _wide_hits, filter_bitmap

    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    check_device_addressable(col.n, f"sharded scan of {col.name!r}")
    if col.scheme == "wide":
        pairs = _pairs(col, mesh, axis)
        valid = _valid_windows(col, mesh, axis, [lo for lo, _ in pairs])
        clo, chi = _stage_value_wide(col.dtype, value)
        kind = np_dtype(col.dtype).kind
        return [(lo, _finish(lo, _wide_hits(decode_shard(lo), decode_shard(hi), clo, chi, kind, op),
                             None if valid is None else valid[i]))
                for i, (lo, hi) in enumerate(pairs)]
    return [(sh, _mask_pad(filter_bitmap(sh.col, op, value, device=sh.device, streams=sh.streams), sh.col.n))
            for sh in _real(col, mesh, axis)]


def gather_words(n: int, mesh: Mesh, parts: list[tuple[Shard, torch.Tensor]]) -> torch.Tensor:
    """The whole (ng, LANES) bitmap on the mesh's first device from every
    shard's words (a gather, so this process must hold every shard)."""
    if mesh.multi_process():
        raise ValueError(
            "the mesh spans several processes: a whole bitmap would need a gather; count with the "
            "*_sharded counts, which all-reduce a scalar"
        )
    first = mesh.first_device()
    if not parts:  # n = 0: one group of zero words
        return torch.zeros((num_groups(n), LANES), dtype=torch.int32, device=first)
    return torch.cat([w.to(first) for _, w in parts])


def count_words(mesh: Mesh, parts: list[tuple[Shard, torch.Tensor]]) -> int:
    """Population count of every shard's words, one all-reduced scalar."""
    from .query import popcount_words

    local = sum(int(popcount_words(w).sum().item()) for _, w in parts)
    return all_reduce([local], mesh)[0]


def filter_bitmap_sharded(col: EncodedColumn, op: str, value, mesh=None, axis="d") -> torch.Tensor:
    """Sharded twin of query.filter_bitmap: the (ng, LANES) int32 LMP(1)
    match words on the mesh's first device, pad bits already zero, each
    shard's folded on its own device."""
    mesh = _mesh(mesh, axis)
    return gather_words(col.n, mesh, _filter_words(col, op, value, mesh, axis))


def count_where_sharded(col: EncodedColumn, op: str, value, mesh=None, axis="d") -> int:
    """Sharded predicate count: each shard's popcount, one scalar
    all-reduce (the scan's only collective)."""
    mesh = _mesh(mesh, axis)
    return count_words(mesh, _filter_words(col, op, value, mesh, axis))


# --- membership -----------------------------------------------------------------


def _isin_words(col: EncodedColumn, values, mesh: Mesh, axis) -> list[tuple[Shard, torch.Tensor]]:
    from .query import _mask_pad, _staged_set_u64, _wide_search_hits, isin_apply, isin_terms

    if col.scheme == "wide":
        staged = _staged_set_u64(col.dtype, values)
        pairs = _pairs(col, mesh, axis)
        if staged is None:
            return [(lo, torch.zeros((lo.g1 - lo.g0, LANES), dtype=torch.int32, device=lo.device))
                    for lo, _ in pairs]
        valid = _valid_windows(col, mesh, axis, [lo for lo, _ in pairs])
        return [(lo, _finish(lo, _wide_search_hits(decode_shard(lo), decode_shard(hi), staged),
                             None if valid is None else valid[i]))
                for i, (lo, hi) in enumerate(pairs)]
    # the set staged on the host once, a search table uploaded once a device
    terms = isin_terms(col, values)
    tables: dict = {}
    out = []
    for sh in _real(col, mesh, axis):
        if terms is not None and terms[0] == "search" and sh.device not in tables:
            tables[sh.device] = torch.from_numpy(terms[1].astype(np.int64)).to(sh.device)
        words = isin_apply(sh.col, terms, sh.device, sh.streams, tables.get(sh.device))
        out.append((sh, _mask_pad(words, sh.col.n)))
    return out


def isin_bitmap_sharded(col: EncodedColumn, values, mesh=None, axis="d") -> torch.Tensor:
    """Sharded twin of query.isin_bitmap: each shard runs the single-GPU
    membership scan (eq scans through K16 for up to 8 values, a search of
    the decoded payloads in the staged set otherwise; wide columns search
    their (hi, lo) pairs). Floats match in bit-pattern space."""
    mesh = _mesh(mesh, axis)
    return gather_words(col.n, mesh, _isin_words(col, values, mesh, axis))


def isin_count_sharded(col: EncodedColumn, values, mesh=None, axis="d") -> int:
    """Sharded membership count (one scalar all-reduce)."""
    mesh = _mesh(mesh, axis)
    return count_words(mesh, _isin_words(col, values, mesh, axis))


def semi_join_bitmap_sharded(probe: EncodedColumn, build: EncodedColumn, mesh=None, axis="d") -> torch.Tensor:
    """Sharded semi-join bitmap: probe rows whose value appears in the
    build column. The build side's distinct set comes from the host (its
    dictionary when it has one); strdict probes scan their code column for
    the set's codes (validity travels with it)."""
    from .table import _distinct_values

    mesh = _mesh(mesh, axis)
    vals = _distinct_values(build, mesh.first_device())
    if probe.scheme == "strdict":
        from .groupby import _codes_device_column
        from .strings import code_set

        return isin_bitmap_sharded(_codes_device_column(probe), code_set(probe, vals), mesh, axis)
    return isin_bitmap_sharded(probe, vals, mesh, axis)


# --- aggregates -----------------------------------------------------------------


def _partials(col: EncodedColumn, agg: str, mesh: Mesh, axis) -> list[tuple]:
    """aggregate._run on each real shard (K17 for nbit, dzbf and for)."""
    from .aggregate import _run

    check_device_addressable(col.n, f"sharded scan of {col.name!r}")
    return [_run(sh.col, agg, sh.device, sh.streams) for sh in _real(col, mesh, axis)]


def _plane_sums(col: EncodedColumn, mesh: Mesh, axis) -> tuple[int, int, int]:
    """(lo, hi, negative count) sums of the shards' sum partials,
    all-reduced: each fits int64."""
    local = [0, 0, 0]
    for parts in _partials(col, "sum", mesh, axis):
        for i, p in enumerate(parts):
            local[i] += int((p.to(torch.int64) & 0xFFFFFFFF).sum().item())
    return tuple(all_reduce(local, mesh))


def sum_sharded(col: EncodedColumn, mesh=None, axis="d") -> int | float:
    """Sharded exact column sum (aggregate.sum_'s semantics, null rows
    skipped)."""
    mesh = _mesh(mesh, axis)
    dt = np_dtype(col.dtype)
    if col.scheme in ("cascade", "dict") and dt.kind != "f":
        # codes counted on the mesh, then the exact O(dict_size) host dot
        from .groupby import key_values

        counts = group_reduce_sharded(col, None, ("count",), mesh=mesh, axis=axis).count
        vals = key_values(col).astype(np.int64)
        return int(sum(int(c) * int(v) for c, v in zip(counts, vals)))
    if dt.kind == "f":
        from .dist import decode_sharded

        v = decode_sharded(col, mesh, axis)
        v = v if isinstance(v, np.ndarray) else v.cpu().numpy()
        if nulls.is_nullable(col):
            v = v[nulls.valid_mask(col)]
        return float(np.sum(v, dtype=np.float64))
    if col.scheme == "wide":
        from . import wide

        lo, hi = (_plane_sums(wide._sub(col, p), mesh, axis) for p in ("lo", "hi"))
        s = lo[0] + (lo[1] << 32) + ((hi[0] + (hi[1] << 32)) << 32)
        if dt.kind == "i":  # two's complement: 2^64 less for each negative
            s -= count_where_sharded(wide._sub(col, "hi"), "ge", 1 << 31, mesh, axis) << 64
        if nulls.is_nullable(col):
            # the plane sums covered the fill values at null rows
            from .partial import take

            s -= sum(int(x) for x in take(col, nulls.null_positions(col), device=mesh.first_device()))
        return s
    lo, hi, neg = _plane_sums(col, mesh, axis)
    s = lo + (hi << 32)
    if dt.kind == "i":
        s -= neg << (8 * dt.itemsize)
    return s


def _minmax_sharded(col: EncodedColumn, agg: str, mesh, axis):
    from .aggregate import _key_unmap_host, _minmax

    if col.n == 0:
        raise ValueError(f"{agg} of an empty column")
    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        raise ValueError(f"{agg} of an all-null column")
    mesh = _mesh(mesh, axis)
    if col.scheme == "wide" or (col.scheme in ("cascade", "dict") and col.params.get("dense")):
        # zone maps and dense dictionaries answer on the host, off the mesh
        return _minmax(col, agg, mesh.first_device())
    pick = max if agg == "max" else min
    # a process with no real shard starts past every int32 key and still enters the all-reduce
    ident = -(1 << 31) - 1 if agg == "max" else 1 << 31
    best = [pick((int((k.max() if agg == "max" else k.min()).item()) for (k,) in _partials(col, agg, mesh, axis)),
                 default=ident)]
    return _key_unmap_host(all_reduce(best, mesh, agg)[0], col.dtype)


def min_sharded(col: EncodedColumn, mesh=None, axis="d"):
    """Sharded column minimum (floats in total order)."""
    return _minmax_sharded(col, "min", mesh, axis)


def max_sharded(col: EncodedColumn, mesh=None, axis="d"):
    """Sharded column maximum (floats in total order)."""
    return _minmax_sharded(col, "max", mesh, axis)


# --- GROUP BY -------------------------------------------------------------------

_REDUCE = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}  # how partials combine


def _host_words(bitmap, n: int) -> np.ndarray:
    """A caller's filter bitmap (a tensor on any device, or NumPy words) as
    host (ng, LANES) int32 words."""
    words = bitmap.cpu().numpy() if isinstance(bitmap, torch.Tensor) else np.asarray(bitmap)
    return words.view(np.int32).reshape(num_groups(n), LANES)


def _row_masks(keys: EncodedColumn, vals: EncodedColumn | None, bitmap, plan: list[Shard]) -> list:
    """Each shard's (g1 - g0, LANES) words of the rows that count (the
    filter bitmap ANDed with the key's and the measure's validity) on its
    device; None entries where every row counts."""
    words = None if bitmap is None else _host_words(bitmap, keys.n)
    for c in (keys, vals):
        if c is not None and nulls.is_nullable(c):
            vw = c.streams["valid"].view(np.int32)
            words = vw if words is None else words & vw
    if words is None:
        return [None] * len(plan)
    return [torch.from_numpy(np.ascontiguousarray(words[sh.g0 : sh.g1])).to(sh.device) for sh in plan]


def _shard_segments(sh: Shard, words, d: int) -> torch.Tensor:
    """(rows,) int64 bucket of each row of a key-code shard: its code, or
    d for pad rows and rows the mask clears."""
    from .groupby import bitmap_rows

    codes = decode_shard(sh).to(torch.int64)
    valid = torch.arange(codes.shape[0], device=sh.device) < sh.col.n
    if words is not None:
        valid &= bitmap_rows(words)
    return torch.where(valid, codes, d)


def _gb_run(keys, vals, bitmap, mesh, axis, *, want_count: bool, want_sum: bool, want_minmax: bool,
            dtype: str | None = None) -> dict[str, np.ndarray]:
    """One sharded pass: each shard folds its codes (and its measure
    shard's payloads) into (d + 1,) partials on its device (groupby._fold);
    the host adds counts and sums and takes the extremes across shards,
    then across processes. Bucket d holds the dropped rows."""
    from .groupby import _codes_device_column, _fold

    check_device_addressable(keys.n, "sharded group_reduce")
    d = keys.params["dict_size"]
    kplan = _real(_codes_device_column(keys), mesh, axis)
    vplan = _real(vals, mesh, axis) if vals is not None else [None] * len(kplan)
    masks = _row_masks(keys, vals, bitmap, kplan)
    total: dict[str, np.ndarray] = {}
    for ksh, vsh, words in zip(kplan, vplan, masks):
        u = decode_shard(vsh) if vsh is not None else None
        parts = _fold(_shard_segments(ksh, words, d), u, dtype or (vals.dtype if vals is not None else None), d,
                      want_count=want_count, want_sum=want_sum, want_minmax=want_minmax)
        for k, t in parts.items():
            a = t.cpu().numpy().astype(np.int64)
            total[k] = a if k not in total else {"min": np.minimum, "max": np.maximum}.get(k, np.add)(total[k], a)
    names = [k for k in ("count", "sum", "min", "max") if (k == "count" and want_count) or (k == "sum" and want_sum)
             or (k in ("min", "max") and want_minmax)]
    if mesh.multi_process():
        for k in names:
            if k not in total:  # this process holds no real shard: the identities
                total[k] = np.full(d + 1, {"min": np.iinfo(np.int32).max, "max": np.iinfo(np.int32).min}.get(k, 0),
                                   np.int64)
            total[k] = np.asarray(all_reduce(total[k].tolist(), mesh, _REDUCE[k]), np.int64)
    return total


def _host_codes_vals(keys: EncodedColumn, vals: EncodedColumn, bitmap, mesh: Mesh, axis):
    """(codes, values, mask) on the host, both decoded sharded: the float
    sums' and wide extremes' host finish."""
    from .dist import decode_sharded
    from .groupby import _codes_device_column, _host_mask

    codes = decode_sharded(_codes_device_column(keys), mesh, axis).cpu().numpy().astype(np.int64)
    v = decode_sharded(vals, mesh, axis)
    v = v if isinstance(v, np.ndarray) else v.cpu().numpy()
    mask = None if bitmap is None else _host_mask(keys.n, torch.from_numpy(_host_words(bitmap, keys.n)))
    for c in (keys, vals):
        if nulls.is_nullable(c):
            mask = nulls.valid_mask(c) if mask is None else mask & nulls.valid_mask(c)
    return codes, v, mask


def group_reduce_sharded(keys, vals=None, aggs=("count",), bitmap=None, mesh=None, axis="d"):
    """Sharded groupby.group_reduce: the same GroupResult (rows with a null
    key or measure drop out), with the codes and the measure decoding
    shard by shard over the mesh. Float sums decode sharded and finish on
    the host in float64, as the single-GPU layer does; 64-bit measures sum
    per plane and take their extremes on int64 keys."""
    from . import groupby as gb

    mesh = _mesh(mesh, axis)
    aggs = tuple(aggs)
    for a in aggs:
        if a not in gb._AGGS:
            raise ValueError(f"agg must be one of {gb._AGGS}, got {a!r}")
    need_vals = any(a != "count" for a in aggs)
    if need_vals and vals is None:
        raise ValueError("sum/min/max require a values column")
    if vals is not None and vals.n != keys.n:
        raise ValueError(f"length mismatch: keys n={keys.n}, vals n={vals.n}")
    if keys.scheme not in ("dict", "cascade", "strdict"):
        gb._codes_device_column(keys)  # raises the explanatory ValueError

    d = keys.params["dict_size"]
    vdt = np_dtype(vals.dtype) if vals is not None else None
    want_sum = "sum" in aggs
    want_minmax = ("min" in aggs) or ("max" in aggs)
    res = gb.GroupResult(keys=gb.key_values(keys), count=None)

    if vals is not None and vals.scheme == "wide":
        from . import wide

        res.count = _gb_run(keys, None, bitmap, mesh, axis, want_count=True, want_sum=False,
                            want_minmax=False)["count"][:d]
        if want_sum and vdt.kind == "f":
            codes, v, mask = _host_codes_vals(keys, vals, bitmap, mesh, axis)
            res.sum = gb._host_group_sum_float(codes, v, d, mask)
        elif want_sum:
            lo = _gb_run(keys, wide._sub(vals, "lo"), bitmap, mesh, axis, want_count=False, want_sum=True,
                         want_minmax=False, dtype="uint32")["sum"][:d]
            # the hi plane sums in the logical signedness
            hi = _gb_run(keys, wide._sub(vals, "hi"), bitmap, mesh, axis, want_count=False, want_sum=True,
                         want_minmax=False, dtype="int32" if vdt.kind == "i" else "uint32")["sum"][:d]
            res.sum = np.array([int(a) + (int(b) << 32) for a, b in zip(lo, hi)], dtype=object)
        if want_minmax:
            codes, v, mask = _host_codes_vals(keys, vals, bitmap, mesh, axis)
            k = gb._wide_keys(torch.from_numpy(v.view(np.int64)), vdt.kind)
            seg = torch.from_numpy(np.where(mask, codes, d) if mask is not None else codes)
            for a in ("min", "max"):
                if a in aggs:
                    setattr(res, a, gb._unmap_wide_keys_host(gb._bucket_extreme(seg, k, d, a)[:d].numpy(), vals.dtype))
        return res

    out = _gb_run(keys, vals if need_vals else None, bitmap, mesh, axis, want_count=True,
                  want_sum=want_sum and vdt is not None and vdt.kind != "f", want_minmax=want_minmax)
    res.count = out["count"][:d]
    if vals is not None and want_sum:
        if vdt.kind == "f":
            codes, v, mask = _host_codes_vals(keys, vals, bitmap, mesh, axis)
            res.sum = gb._host_group_sum_float(codes, v, d, mask)
        else:
            res.sum = out["sum"][:d]
    if vals is not None and want_minmax:
        for a in ("min", "max"):
            if a in aggs:
                setattr(res, a, gb._unmap_keys_host(out[a][:d].astype(np.int32), vals.dtype))
    return res

