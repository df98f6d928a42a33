"""Table façade: the multi-column scan API over a container.

Counterpart of giddy_tpu/table.py. A ``Table`` binds same-length encoded
columns and routes the scan pipeline through the per-column machinery:
numeric predicates to query.py (K16 over packed words, or a decode kernel
and a compare on the card), string predicates to strings.py's dictionary
range rewrite, GROUP BY to groupby.py, ORDER BY to topk.py. Predicates
compose on LMP(1) bitmaps, (ng, LANES) int32 tensors that stay on the
card, so a multi-column WHERE ANDs there; rows materialize on the host only
at the end, and only for the selected columns' matching groups.

A Table lives on one device: the card unless it was built with
``device="cpu"``; every method runs there, and the Tables a method builds
(``sort_by``, ``filter``, ``join_table``) stay there. Bitmaps that a
caller passes in may be tensors or NumPy arrays of the same words. The
joins take ``mesh=`` (dist.Mesh) to run their prunes sharded.
"""

from __future__ import annotations

import numpy as np
import torch

from .format import EncodedColumn
from .util import LANES, num_groups


def _host(x) -> np.ndarray:
    """A decoded column (tensor, or a strdict's NumPy array) on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _words(bitmap, device) -> torch.Tensor:
    """A caller's bitmap words as an int32 tensor on ``device``."""
    if isinstance(bitmap, torch.Tensor):
        return bitmap.to(device)
    a = np.array(bitmap)  # a copy: the caller's words may be read-only
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)


def _bitmap_indices(bitmap, n: int) -> np.ndarray:
    """Row positions of the set bits of an LMP(1) bitmap over n rows."""
    from .ref.lmp import lmp_unpack

    words = _host(bitmap).view(np.uint32).reshape(num_groups(n), LANES)
    return np.flatnonzero(lmp_unpack(words, 1, n).astype(bool))


def _distinct_values(col: EncodedColumn, device: torch.device | str = "cuda"):
    """The distinct NON-NULL values of a column (the semi-join build set).
    Dictionary-backed columns answer from the dictionary (dense: every
    entry occurs; strdict dictionaries are always dense); anything else
    decodes on ``device`` and uniques on the host (null rows excluded)."""
    from . import nulls

    if col.scheme == "strdict":
        from .strings import dictionary

        d = dictionary(col)
        if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
            return []
        return list(d)
    from .util import np_dtype

    is_float = np_dtype(col.dtype).kind == "f"
    if col.scheme in ("dict", "cascade") and col.params.get("dense") and not is_float:
        if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
            return []
        from .groupby import key_values

        return [int(v) for v in key_values(col)]
    from .api import decode

    v = _host(decode(col, device=device))
    if nulls.is_nullable(col):
        v = v[nulls.valid_mask(col)]
    if is_float:
        # distinct in bit-pattern space (matches the device membership scan)
        w = np.unique(v.view(np.uint32 if v.dtype.itemsize == 4 else np.uint64))
        return [float(x) for x in w.view(v.dtype)]
    return [int(x) for x in np.unique(v)]


class Table:
    """Named, same-length encoded columns with a scan API, on ``device``."""

    def __init__(self, columns, *, device: torch.device | str = "cuda"):
        cols = list(columns.values()) if isinstance(columns, dict) else list(columns)
        if not cols:
            raise ValueError("a Table needs at least one column")
        names = [c.name for c in cols]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        n = cols[0].n
        for c in cols:
            if c.n != n:
                raise ValueError(f"column {c.name!r} has n={c.n}, expected {n}")
        self._cols = {c.name: c for c in cols}
        self.n = n
        self.device = torch.device(device)

    # --- plumbing ---------------------------------------------------------

    @classmethod
    def from_arrays(cls, arrays, schemes=None, *, device: torch.device | str = "cuda") -> "Table":
        """Build a Table from named host arrays (the ingestion twin of
        ``select``). Numeric columns route through the advisor
        (``scheme='auto'``) unless ``schemes[name]`` overrides; 64-bit
        dtypes go through the ``wide`` plane split; str/bytes sequences
        become ``strdict`` columns; datetime64/timedelta64 store their int64
        ticks as wide with a ``logical`` tag. A value may be an ``(array,
        valid)`` pair to make the column nullable."""
        from . import nulls
        from .api import encode
        from .strings import encode_strings
        from .wide import encode as wide_encode

        schemes = schemes or {}
        cols = []
        for name, v in arrays.items():
            valid = None
            if isinstance(v, tuple):
                v, valid = v
                valid = np.asarray(valid, bool)
            arr = np.asarray(v)
            if arr.dtype.kind in ("U", "S", "O"):
                cols.append(encode_strings(list(v), name=name, valid=valid))
                continue
            logical = None
            if arr.dtype.kind in ("M", "m"):
                logical, arr = str(arr.dtype), arr.view(np.int64)
            scheme = schemes.get(name, "auto")
            if logical is not None or (arr.dtype.itemsize == 8 and scheme in ("auto", "wide")):
                if valid is not None:
                    col = nulls.attach_valid(wide_encode(nulls.fill_nulls(arr, valid), name=name), valid)
                else:
                    col = wide_encode(arr, name=name)
                if logical is not None:
                    col.params = {**col.params, "logical": logical}
                cols.append(col)
                continue
            cols.append(encode(arr, scheme, valid=valid, name=name))
        return cls(cols, device=device)

    @classmethod
    def from_pandas(cls, df, schemes=None, *, downcast: bool = True, dtypes=None,
                    device: torch.device | str = "cuda") -> "Table":
        """Encode a pandas DataFrame (the inverse of ``to_pandas``), with
        giddy_tpu/table.py:133's conventions: missing values become null
        rows, ``downcast`` narrows 64-bit integer columns that fit in 32
        bits, ``dtypes`` pins named numeric columns to exact dtypes (values
        that do not fit raise)."""
        arrays = {}
        for name in df.columns:
            ser = df[name]
            na = ser.isna().to_numpy()
            has_na = bool(na.any())
            if ser.dtype == object or str(ser.dtype) in ("string", "str"):
                vals = ["" if m else x for x, m in zip(ser.tolist(), na)]
                arrays[name] = (np.array(vals, dtype=object), ~na) if has_na else np.array(vals, dtype=object)
                continue
            if getattr(ser.dtype, "kind", "") in ("M", "m"):
                # tz-aware timestamps normalize to naive UTC first
                if getattr(ser.dtype, "tz", None) is not None:
                    ser = ser.dt.tz_convert("UTC").dt.tz_localize(None)
                v = ser.to_numpy()
                arrays[name] = (v, ~na) if has_na else v
                continue
            np_dt = getattr(ser.dtype, "numpy_dtype", None)  # masked extension dtypes
            v = ser.to_numpy(dtype=np_dt, na_value=0) if np_dt is not None else ser.to_numpy()
            if v.dtype == object:
                v = np.where(na, 0, v).astype(np.int64)
            if v.dtype.kind == "b":
                v = v.astype(np.int8)
            if has_na and v.dtype.kind == "f":
                # NaN slots: a defined payload before the canonical null fill
                v = np.where(na, np.zeros((), v.dtype), v)
            if (downcast and v.dtype.kind in "iu" and v.dtype.itemsize == 8
                    and (schemes or {}).get(name) != "wide" and v.size):
                lo, hi = int(v.min()), int(v.max())
                if -(2**31) <= lo and hi < 2**31:
                    v = v.astype(np.int32)
                elif 0 <= lo and hi < 2**32:
                    v = v.astype(np.uint32)
            want = (dtypes or {}).get(name)
            if want is not None and v.dtype.kind in "iuf" and v.dtype != np.dtype(want):
                conv = v.astype(want)
                if not np.array_equal(conv.astype(v.dtype), v):
                    raise ValueError(f"column {name!r}: values do not fit pinned dtype {want}")
                v = conv
            arrays[name] = (v, ~na) if has_na else v
        return cls.from_arrays(arrays, schemes, device=device)

    @classmethod
    def read(cls, data, *, device: torch.device | str = "cuda") -> "Table":
        """From container bytes / a file object (format.read_container)."""
        from .format import read_container

        return cls(read_container(data), device=device)

    @classmethod
    def open(cls, path: str, *, device: torch.device | str = "cuda") -> "Table":
        from .format import open_container

        return cls(open_container(path), device=device)

    def to_bytes(self) -> bytes:
        from .format import container_bytes

        return container_bytes(list(self._cols.values()))

    def save(self, path: str) -> None:
        from .format import write_container

        with open(path, "wb") as f:
            write_container(list(self._cols.values()), f)

    @property
    def names(self) -> list[str]:
        return list(self._cols)

    def __getitem__(self, name: str) -> EncodedColumn:
        try:
            return self._cols[name]
        except KeyError:
            raise KeyError(f"no column {name!r}; have {self.names}") from None

    def __len__(self) -> int:
        return self.n

    # --- predicates ---------------------------------------------------------

    def where(self, name: str, op: str, value) -> torch.Tensor:
        """LMP(1) match bitmap for one predicate: string columns route to
        the dictionary rewrite (startswith/contains included), numeric
        columns to the filter kernels. ``op`` may also be ``between``
        (value = (lo, hi), inclusive) or ``isin`` (value = iterable)."""
        col = self[name]
        if op == "isin":
            return self.isin(name, value)
        if op == "between":
            lo, hi = value
            if col.scheme == "strdict":
                from .strings import filter_bitmap_str

                return (filter_bitmap_str(col, "ge", lo, device=self.device)
                        & filter_bitmap_str(col, "le", hi, device=self.device))
            from .query import between_bitmap

            return between_bitmap(col, lo, hi, device=self.device)
        if col.scheme == "strdict":
            from .strings import filter_bitmap_str

            return filter_bitmap_str(col, op, value, device=self.device)
        from .query import filter_bitmap

        return filter_bitmap(col, op, value, device=self.device)

    def where_all(self, *predicates) -> torch.Tensor:
        """AND of (name, op, value) predicates, the multi-column WHERE: the
        bitmaps combine on the card."""
        bm = None
        for name, op, value in predicates:
            b = self.where(name, op, value)
            bm = b if bm is None else (bm & b)
        if bm is None:
            raise ValueError("where_all needs at least one predicate")
        return bm

    def where_any(self, *predicates) -> torch.Tensor:
        """OR of (name, op, value) predicates. Over nullable columns SQL's
        three-valued logic holds per term only (a null row matches no
        term, hence never the OR)."""
        bm = None
        for name, op, value in predicates:
            b = self.where(name, op, value)
            bm = b if bm is None else (bm | b)
        if bm is None:
            raise ValueError("where_any needs at least one predicate")
        return bm

    def count(self, *predicates) -> int:
        from .query import count_bits

        return count_bits(self.where_all(*predicates), self.n)

    def isin(self, name: str, values) -> torch.Tensor:
        """Membership bitmap: string columns via the dictionary, numeric
        via eq scans (small sets) or a search on the card (large sets)."""
        col = self[name]
        if col.scheme == "strdict":
            from .strings import isin_bitmap_str

            return isin_bitmap_str(col, values, device=self.device)
        from .query import isin_bitmap

        return isin_bitmap(col, values, device=self.device)

    def semi_join(self, name: str, other, other_name: str | None = None) -> torch.Tensor:
        """Bitmap of rows whose ``name`` value appears in another column
        (WHERE a.x IN (SELECT y FROM b)). ``other`` is a Table (with
        ``other_name``) or an EncodedColumn. Dictionary-backed probe columns
        test membership over their dictionary; others go through isin. Null
        rows on either side never match."""
        col = self[name]
        build = other[other_name] if isinstance(other, Table) else other
        build_set = _distinct_values(build, self.device)
        if col.scheme == "strdict":
            from .strings import isin_bitmap_str

            return isin_bitmap_str(col, list(build_set), device=self.device)
        from .util import np_dtype

        if col.scheme in ("dict", "cascade") and np_dtype(col.dtype).kind != "f":
            from .groupby import key_values
            from .query import dict_mask_bitmap

            kv = key_values(col)
            want = set(int(v) for v in build_set)
            mask = np.fromiter((int(v) in want for v in kv), bool, count=kv.shape[0])
            return dict_mask_bitmap(col, mask, device=self.device)
        from .query import isin_bitmap

        return isin_bitmap(col, list(build_set), device=self.device)

    def join(self, on: str, other: "Table", other_on: str | None = None,
             select=None, other_select=None, suffix: str = "_r", *, mesh=None, how: str = "inner"):
        """Materialized equi-join (join.join_tables): ``(rows, li, ri)``,
        the joined output columns and the matched row-index pairs (the
        prunes sharded over ``mesh`` when given). Null keys never match;
        ``how`` is "inner", "left" or "outer"."""
        from .join import join_tables

        return join_tables(self, on, other, other_on, select, other_select, suffix, mesh=mesh, how=how)

    def join_table(self, on: str, other: "Table", other_on: str | None = None,
                   select=None, other_select=None, suffix: str = "_r", *,
                   mesh=None, how: str = "inner", schemes=None) -> "Table":
        """Like :meth:`join` but an encoded Table, whose unmatched outer
        cells are real NULL rows (join.join_table)."""
        from .join import join_table

        return join_table(self, on, other, other_on, select, other_select, suffix, mesh=mesh, how=how,
                          schemes=schemes)

    def anti_join(self, name: str, other, other_name: str | None = None) -> torch.Tensor:
        """Bitmap of rows whose non-null ``name`` value has NO match in the
        other column (NOT EXISTS)."""
        from .join import anti_join_bitmap

        build = other[other_name or name] if isinstance(other, Table) else other
        return anti_join_bitmap(self[name], build, device=self.device)

    # --- materialization ------------------------------------------------------

    def select(self, names=None, bitmap=None, *predicates) -> dict[str, np.ndarray]:
        """Rows matching ``bitmap`` (or the AND of ``predicates``) for the
        requested columns, as NumPy; decodes only the groups holding
        matches. With neither, decodes the full columns."""
        names = self.names if names is None else list(names)
        if predicates:
            pbm = self.where_all(*predicates)
            bitmap = pbm if bitmap is None else (_words(bitmap, self.device) & pbm)
        if bitmap is None:
            from .api import decode

            return {nm: _host(decode(self[nm], device=self.device)) for nm in names}
        idx = _bitmap_indices(bitmap, self.n)
        return {nm: self.take(nm, idx) for nm in names}

    def take(self, name: str, indices) -> np.ndarray:
        """Rows at ``indices`` of one column (NumPy; strings an object
        array), decoding on the Table's device only the groups they touch."""
        from .partial import take

        col = self[name]
        if col.scheme == "strdict":
            from .strings import codes_column, dictionary

            codes = take(codes_column(col), indices, device=self.device)
            return dictionary(col)[codes.astype(np.int64)]
        return take(col, indices, device=self.device)

    # --- aggregates -------------------------------------------------------------

    def agg(self, name: str, agg: str):
        """sum/min/max/avg/count/distinct (null-aware; strings answer
        min/max/distinct from the dictionary)."""
        from .nulls import count_valid

        col = self[name]
        if col.scheme == "strdict":
            from . import strings

            fn = {"min": strings.min_str, "max": strings.max_str, "distinct": strings.distinct_count_str}
            if agg == "count":
                return count_valid(col)
            if agg not in fn:
                raise ValueError(f"string columns support min/max/distinct/count, not {agg!r}")
            return fn[agg](col)
        from .aggregate import avg_, distinct_count, max_, min_, sum_

        fn = {"sum": sum_, "min": min_, "max": max_, "avg": avg_, "distinct": distinct_count}
        if agg == "count":
            return count_valid(col)
        if agg not in fn:
            raise ValueError(f"agg must be one of {sorted([*fn, 'count'])}, got {agg!r}")
        return fn[agg](col, device=self.device)

    def groupby(self, keys, vals: str | None = None, aggs=("count",), *predicates):
        """GROUP BY one dictionary-backed (dict/cascade/strdict) key
        column, or several (a list of names; result keys are per-column
        tuples), optionally under the AND of (name, op, value) predicates."""
        from .groupby import group_reduce, group_reduce_multi

        bm = self.where_all(*predicates) if predicates else None
        v = self[vals] if vals else None
        if isinstance(keys, (list, tuple)):
            return group_reduce_multi([self[k] for k in keys], v, tuple(aggs), bm, device=self.device)
        return group_reduce(self[keys], v, tuple(aggs), bm, device=self.device)

    def distinct(self, names):
        """SELECT DISTINCT: the unique values of one column, or the unique
        combinations (tuples) of several dictionary-backed columns."""
        if isinstance(names, str):
            return _distinct_values(self[names], self.device)
        r = self.groupby(list(names))
        return [k for k, c in zip(r.keys, r.count) if c > 0]

    def to_pandas(self, bitmap=None, *predicates):
        """The table (or its matching rows) as a pandas DataFrame; nullable
        columns surface as pandas NA (NaT for times)."""
        import pandas as pd

        from .nulls import is_nullable, valid_mask

        bm = None
        if predicates:
            bm = self.where_all(*predicates)
            if bitmap is not None:
                bm = _words(bitmap, self.device) & bm
        elif bitmap is not None:
            bm = bitmap
        rows = self.select(None, bm)
        idx = None if bm is None else _bitmap_indices(bm, self.n)
        df = pd.DataFrame(rows)
        for nm in self.names:
            col = self[nm]
            logical = col.params.get("logical", "")
            is_time = logical.startswith(("datetime64", "timedelta64"))
            if is_time:  # int64 ticks (from_arrays); NaT marks the nulls
                df[nm] = pd.Series(np.asarray(rows[nm], np.int64).view(np.dtype(logical)))
            if is_nullable(col):
                m = valid_mask(col) if idx is None else valid_mask(col)[idx]
                if is_time:
                    s = df[nm].copy()
                    s[~m] = pd.NaT
                else:
                    s = df[nm].astype(object)
                    s[~m] = pd.NA
                df[nm] = s
        return df

    def _sort_key(self, name: str, ascending: bool):
        """(key, nulls_last) arrays for one sort column: monotone int keys
        (strdict by code, floats in total order), descending through
        dense-rank negation (ties keep their order), null keys zeroed with
        a separate NULLS LAST flag."""
        from . import nulls
        from .zonemap import _keys

        col = self[name]
        from .api import decode

        if col.scheme == "strdict":
            from .strings import codes_column

            # codes follow the bytes-sorted dictionary: sorting by code IS
            # sorting by string
            key = _host(decode(codes_column(col), device=self.device)).astype(np.int64)
        else:
            key = _keys(_host(decode(col, device=self.device)), col.dtype)
        if not ascending:
            from .util import sorted_factorize

            _, inv = sorted_factorize(key)
            key = -inv.astype(np.int64)
        if nulls.is_nullable(col):
            m = nulls.valid_mask(col)
            nulls_last = ~m
            key = np.where(m, key, np.zeros((), key.dtype))
        else:
            nulls_last = np.zeros(self.n, bool)
        return key, nulls_last

    def sort_by(self, names, *, ascending=True, schemes=None) -> "Table":
        """A new Table with rows reordered by one or several columns and
        every column re-encoded (advisor unless ``schemes`` overrides).
        Stable; null keys sort last per key; floats order by IEEE total
        order. ``ascending`` may be one bool or a list matching ``names``."""
        names = [names] if isinstance(names, str) else list(names)
        if isinstance(ascending, bool):
            ascending = [ascending] * len(names)
        if len(ascending) != len(names):
            raise ValueError("ascending must match names")
        # lexsort: the LAST key is primary; the index breaks ties stably
        ks = [self._sort_key(nm, asc) for nm, asc in zip(names, ascending)]
        cols = [np.arange(self.n)]
        for key, nl in reversed(ks):
            cols += [key, nl]
        return self._take_table(np.lexsort(tuple(cols)), schemes)

    def _take_table(self, idx: np.ndarray, schemes=None) -> "Table":
        """Rows at ``idx`` as a new re-encoded Table on the same device
        (validity masks and logical dtype tags kept): sort_by and filter."""
        from . import nulls

        arrays = {}
        logical = {}
        for nm in self.names:
            c = self[nm]
            vals = self.take(nm, idx)
            if c.params.get("logical"):
                logical[nm] = c.params["logical"]
            arrays[nm] = (vals, nulls.valid_mask(c)[idx]) if nulls.is_nullable(c) else vals
        out = Table.from_arrays(arrays, schemes, device=self.device)
        for nm, lg in logical.items():
            out[nm].params = {**out[nm].params, "logical": lg}
        return out

    def filter(self, *predicates, bitmap=None, schemes=None) -> "Table":
        """A new Table of only the rows matching the AND of (name, op,
        value) predicates (or an explicit bitmap), re-encoded with the
        advisor: the materializing sibling of ``select``."""
        if predicates:
            pbm = self.where_all(*predicates)
            bitmap = pbm if bitmap is None else (_words(bitmap, self.device) & pbm)
        if bitmap is None:
            raise ValueError("filter needs predicates or a bitmap")
        idx = _bitmap_indices(bitmap, self.n)
        if idx.size == 0:
            raise ValueError("filter matched no rows (a Table cannot be empty)")
        return self._take_table(idx, schemes)

    def top_k(self, name: str, k: int, *, largest: bool = True, select=None):
        """ORDER BY name LIMIT k: (values, positions), plus the other
        requested columns' rows at those positions."""
        from .topk import top_k

        vals, pos = top_k(self[name], k, largest=largest, device=self.device)
        if select is None:
            return vals, pos
        return vals, pos, {nm: self.take(nm, pos) for nm in select}
