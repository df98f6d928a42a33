"""Partitioned datasets: a directory of containers scanned as one table.

Counterpart of giddy_tpu/dataset.py, with the same on-disk format: one
container a partition (``part-%05d.gtp``) and a ``manifest.json`` of exact
per-partition, per-column [min, max] zones, written with the same keys and
values, so a dataset written by either package opens in the other. Every
Table scan lifts to the dataset:

- predicates prune whole partitions from the manifest before any device
  work ("skip", "all" or "scan", the reference's answers exactly);
- counts short-circuit partitions the zones prove all-match;
- min/max answer from the manifest (the zones are exact, built by the
  fused aggregates on the card at write time);
- GROUP BY merges per-partition results by key on the host.

A Dataset lives on one device (the card unless opened or written with
``device="cpu"``), and so do the Tables of its partitions; ``count`` and
``agg`` take ``mesh=`` (dist.Mesh) to spread one partition's groups over
several devices (dist_query).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .table import Table

_MANIFEST = "manifest.json"
_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


def _zones_for(table: Table) -> dict:
    """Exact per-column min/max for the manifest (numeric columns only;
    the fused aggregates on the table's device). Columns whose extremes do
    not fit JSON exactly (NaN zones, all-null) are left out and never
    prune."""
    from .aggregate import max_, min_
    from .nulls import count_valid, is_nullable
    from .util import np_dtype

    zones = {}
    for nm in table.names:
        col = table[nm]
        if col.scheme == "strdict":
            continue
        if is_nullable(col) and count_valid(col) == 0:
            continue
        if col.n == 0:  # the reference's min_ raises here and skips the column
            continue
        lo, hi = min_(col, device=table.device), max_(col, device=table.device)
        if np_dtype(col.dtype).kind == "f":
            lo, hi = float(lo), float(hi)
            if np.isnan(lo) or np.isnan(hi):
                continue
        else:
            lo, hi = int(lo), int(hi)
        zones[nm] = [lo, hi]
    return zones


def _stage(dtype: str | None, value):
    """Predicate value -> the comparison key the device scan uses (query.py
    staging: floats round to the column's precision and compare in IEEE
    total order; ints truncate toward zero). None = the zones cannot reason
    about it (unknown dtype, out-of-range wrap) -> always 'scan'."""
    from .util import np_dtype

    if dtype is None:
        return None
    try:
        dt = np_dtype(dtype)
    except KeyError:
        return None
    try:
        if dt.kind == "f":
            from .zonemap import _key_scalar

            v = np.float64(value) if dt.itemsize == 8 else np.float32(value)
            return int(_key_scalar(float(v), dtype))
        v = int(np.int64(value))
    except (OverflowError, TypeError, ValueError):
        return None
    info = np.iinfo(dt)
    if not (int(info.min) <= v <= int(info.max)):
        return None  # device compares wrap mod 2**32; zones cannot model that
    return v


def _zone_keys(dtype: str | None, zone):
    """Manifest zone [min, max] -> the key space of _stage (floats to
    total-order keys; ints as they are). None disables pruning."""
    if zone is None or dtype is None:
        return None
    from .util import np_dtype

    try:
        dt = np_dtype(dtype)
    except KeyError:
        return None
    if dt.kind != "f":
        return zone
    from .zonemap import _key_scalar

    try:
        return [int(_key_scalar(float(zone[0]), dtype)), int(_key_scalar(float(zone[1]), dtype))]
    except (TypeError, ValueError):
        return None


def _prune(zone, op: str, value) -> str:
    """'skip' (no row can match), 'all' (every non-null row matches), or
    'scan'. ``value`` must already be staged (_stage)."""
    if zone is None or value is None:
        return "scan"
    lo, hi = zone
    try:
        if op == "lt":
            return "skip" if lo >= value else ("all" if hi < value else "scan")
        if op == "le":
            return "skip" if lo > value else ("all" if hi <= value else "scan")
        if op == "gt":
            return "skip" if hi <= value else ("all" if lo > value else "scan")
        if op == "ge":
            return "skip" if hi < value else ("all" if lo >= value else "scan")
        if op == "eq":
            return "skip" if (value < lo or value > hi) else ("all" if lo == hi == value else "scan")
        if op == "ne":
            return "skip" if lo == hi == value else ("all" if (value < lo or value > hi) else "scan")
    except TypeError:  # cross-type compare (e.g. a bytes value on a numeric zone)
        return "scan"
    return "scan"


class Dataset:
    """A directory of same-schema containers with a zone manifest."""

    def __init__(self, path: str, manifest: dict, *, device: torch.device | str = "cuda"):
        self.path = path
        self.manifest = manifest
        self.device = torch.device(device)
        self._parts: dict[int, Table] = {}

    # --- construction -----------------------------------------------------

    @classmethod
    def open(cls, path: str, *, device: torch.device | str = "cuda") -> "Dataset":
        with open(os.path.join(path, _MANIFEST)) as f:
            return cls(path, json.load(f), device=device)

    @classmethod
    def write(cls, path: str, tables, *, overwrite: bool = False, device: torch.device | str = "cuda") -> "Dataset":
        """Create a dataset from an iterable of Tables (one partition
        each; all must share column names). The zones are computed on
        ``device``."""
        os.makedirs(path, exist_ok=True)
        mpath = os.path.join(path, _MANIFEST)
        if os.path.exists(mpath) and not overwrite:
            raise FileExistsError(f"{mpath} exists (pass overwrite=True)")
        ds = cls(path, {"version": 1, "columns": None, "partitions": []}, device=device)
        for t in tables:
            ds.append(t, _save_manifest=False)
        ds._save_manifest()
        return ds

    @classmethod
    def from_pandas(cls, path: str, df, *, rows_per_partition: int = 1 << 24, schemes=None,
                    overwrite: bool = False, device: torch.device | str = "cuda") -> "Dataset":
        """Chunk a DataFrame into partitions and encode each
        (Table.from_pandas per chunk)."""
        def chunks():
            for s in range(0, len(df), rows_per_partition):
                yield Table.from_pandas(df.iloc[s : s + rows_per_partition], schemes=schemes, device=device)

        return cls.write(path, chunks(), overwrite=overwrite, device=device)

    @classmethod
    def from_csv(cls, path: str, csv_path: str, *, rows_per_partition: int = 1 << 22, schemes=None,
                 overwrite: bool = False, device: torch.device | str = "cuda", **read_kw) -> "Dataset":
        """Stream a CSV of any size into partitions through pandas' chunked
        reader. Later chunks are held to the first chunk's dtypes with an
        exactness check, so a value that no longer fits raises instead of
        wrapping; pass read_kw ``dtype=`` to pin wider types up front."""
        import pandas as pd

        def chunks():
            target = None
            for chunk in pd.read_csv(csv_path, chunksize=rows_per_partition, **read_kw):
                t = Table.from_pandas(chunk.reset_index(drop=True), schemes=schemes, dtypes=target, device=device)
                if target is None:
                    target = {nm: t[nm].dtype for nm in t.names
                              if t[nm].scheme != "strdict" and not t[nm].params.get("logical")}
                yield t

        return cls.write(path, chunks(), overwrite=overwrite, device=device)

    def append(self, table: Table, *, _save_manifest: bool = True) -> None:
        """Add one partition (batch arrival). Column names and dtypes must
        match (the manifest's zone staging depends on the dtype)."""
        from .nulls import is_nullable

        cols = self.manifest["columns"]
        if cols is None:
            self.manifest["columns"] = table.names
            self.manifest["dtypes"] = {nm: table[nm].dtype for nm in table.names}
        elif table.names != cols:
            raise ValueError(f"partition columns {table.names} != dataset {cols}")
        else:
            dts = self.manifest.get("dtypes") or {}
            for nm in table.names:
                want = dts.get(nm)
                if want is not None and table[nm].dtype != want:
                    raise ValueError(
                        f"partition column {nm!r} has dtype {table[nm].dtype}, dataset expects {want} "
                        f"(encode with matching dtype, or rebuild the dataset)"
                    )
        i = len(self.manifest["partitions"])
        fname = f"part-{i:05d}.gtp"
        table.save(os.path.join(self.path, fname))
        table = Table(table._cols, device=self.device)  # the partition on the dataset's device
        self.manifest["partitions"].append(
            {"file": fname, "rows": table.n, "zones": _zones_for(table),
             "nullable": [nm for nm in table.names if is_nullable(table[nm])]}
        )
        self._parts[i] = table
        if _save_manifest:
            self._save_manifest()

    def _save_manifest(self) -> None:
        with open(os.path.join(self.path, _MANIFEST), "w") as f:
            json.dump(self.manifest, f, indent=1)

    # --- plumbing ---------------------------------------------------------

    @property
    def names(self) -> list[str]:
        return list(self.manifest["columns"] or [])

    @property
    def n_partitions(self) -> int:
        return len(self.manifest["partitions"])

    def __len__(self) -> int:
        return sum(p["rows"] for p in self.manifest["partitions"])

    def part(self, i: int) -> Table:
        t = self._parts.get(i)
        if t is None:
            t = self._parts[i] = Table.open(os.path.join(self.path, self.manifest["partitions"][i]["file"]),
                                            device=self.device)
        return t

    def _scan_plan(self, predicates) -> list[tuple[int, str]]:
        return self._plan(predicates) if predicates else [(i, "scan") for i in range(self.n_partitions)]

    def _plan(self, predicates) -> list[tuple[int, str]]:
        """Per-partition decision for the AND of predicates: 'skip' if any
        predicate proves no match, 'all' if every predicate proves
        all-match, else 'scan'."""
        dts = self.manifest.get("dtypes") or {}
        staged = []
        for name, op, value in predicates:
            if op == "between":  # zone-wise: ge lo AND le hi
                staged.append((name, "ge", _stage(dts.get(name), value[0])))
                staged.append((name, "le", _stage(dts.get(name), value[1])))
            elif op == "isin":
                vs = [_stage(dts.get(name), v) for v in value]
                staged.append((name, "isin", None if any(v is None for v in vs) else vs))
            else:
                staged.append((name, op, _stage(dts.get(name), value)))
        out = []
        for i, p in enumerate(self.manifest["partitions"]):
            verdicts = []
            for name, op, sv in staged:
                z = _zone_keys(dts.get(name), p["zones"].get(name))
                if op == "isin":
                    if z is None or sv is None:
                        verdicts.append("scan")
                    else:  # skip when every set value falls outside the zone
                        verdicts.append("skip" if all(x < z[0] or x > z[1] for x in sv) else "scan")
                else:
                    verdicts.append(_prune(z, op, sv))
            if any(v == "skip" for v in verdicts):
                out.append((i, "skip"))
            elif all(v == "all" for v in verdicts):
                out.append((i, "all"))
            else:
                out.append((i, "scan"))
        return out

    def _nullable_involved(self, i: int, predicates) -> bool:
        p = self.manifest["partitions"][i]
        if "nullable" in p:  # the manifest answers: no container I/O
            nn = set(p["nullable"])
            return any(name in nn for name, _, _ in predicates)
        from .nulls import is_nullable

        t = self.part(i)
        return any(is_nullable(t[name]) for name, _, _ in predicates)

    # --- scans ------------------------------------------------------------

    def count(self, *predicates, mesh=None) -> int:
        """Rows matching the AND of (name, op, value) predicates. Skipped
        partitions cost nothing; proven-all ones a manifest lookup (unless
        a predicate column is nullable there: null rows never match). With
        ``mesh``, each scanned partition's predicates run sharded."""
        if not predicates:
            return len(self)
        total = 0
        for i, verdict in self._plan(predicates):
            if verdict == "skip":
                continue
            if verdict == "all" and not self._nullable_involved(i, predicates):
                total += self.manifest["partitions"][i]["rows"]
                continue
            if mesh is not None:
                total += self._count_sharded(i, predicates, mesh)
            else:
                total += self.part(i).count(*predicates)
        return total

    def _count_sharded(self, i: int, predicates, mesh) -> int:
        from .dist_query import filter_bitmap_sharded
        from .query import count_bits
        from .strings import filter_bitmap_str_sharded

        t = self.part(i)
        if any(op in ("between", "isin") for _, op, _ in predicates):
            return t.count(*predicates)  # compound ops: the single-GPU path
        bm = None
        for name, op, value in predicates:
            col = t[name]
            fb = filter_bitmap_str_sharded if col.scheme == "strdict" else filter_bitmap_sharded
            b = fb(col, op, value, mesh)
            bm = b if bm is None else bm & b
        return count_bits(bm, t.n)

    def agg(self, name: str, agg: str, *, mesh=None):
        """sum/min/max/avg/count/distinct across all partitions; min/max of
        numeric columns from the manifest zones (exact). With ``mesh``,
        each partition's sum folds sharded."""
        from .table import _distinct_values

        parts = self.manifest["partitions"]
        if not parts:
            raise ValueError("empty dataset")
        if agg in ("min", "max"):
            zs = [p["zones"].get(name) for p in parts]
            if all(z is not None for z in zs):
                vals = [z[0] if agg == "min" else z[1] for z in zs]
                return min(vals) if agg == "min" else max(vals)
            rs = [self.part(i).agg(name, agg) for i in range(len(parts))]
            rs = [r for r in rs if r is not None]
            return (min(rs) if agg == "min" else max(rs)) if rs else None
        if agg == "sum" and mesh is not None:
            from .dist_query import sum_sharded

            return sum(sum_sharded(self.part(i)[name], mesh) for i in range(len(parts)))
        if agg in ("count", "sum"):
            return sum(self.part(i).agg(name, agg) for i in range(len(parts)))
        if agg == "avg":
            cnt = self.agg(name, "count")
            return float(self.agg(name, "sum", mesh=mesh)) / cnt if cnt else float("nan")
        if agg == "distinct":
            seen: set = set()
            for i in range(len(parts)):
                seen.update(_distinct_values(self.part(i)[name], self.device))
            return len(seen)
        raise ValueError(f"agg must be one of sum/min/max/avg/count/distinct, got {agg!r}")

    def select(self, names=None, *predicates) -> dict[str, np.ndarray]:
        """Matching rows across partitions, in partition order (skipped
        partitions decode nothing)."""
        names = self.names if names is None else list(names)
        chunks: list[dict] = []
        for i, verdict in self._scan_plan(predicates):
            if verdict == "skip":
                continue
            t = self.part(i)
            chunks.append(t.select(names, None, *predicates) if predicates else t.select(names))
        if not chunks:
            if self.n_partitions:  # typed empties matching the real schema
                e = np.empty(0, np.int64)
                return {nm: self.part(0).take(nm, e) for nm in names}
            return {nm: np.empty(0) for nm in names}
        return {nm: np.concatenate([c[nm] for c in chunks]) for nm in names}

    def groupby(self, keys: str, vals: str | None = None, aggs=("count",), *predicates):
        """GROUP BY across partitions: per-partition group_reduce, merged
        by key on the host (counts and sums add; min of mins, max of maxs)."""
        from .groupby import GroupResult

        aggs = tuple(aggs)
        merged: dict = {}
        for i, verdict in self._scan_plan(predicates):
            if verdict == "skip":
                continue
            r = self.part(i).groupby(keys, vals, aggs, *predicates)
            for j, k in enumerate(np.asarray(r.keys)):
                kk = k.item() if hasattr(k, "item") else k
                m = merged.get(kk)
                if m is None:
                    merged[kk] = m = {"count": 0, "sum": 0, "min": None, "max": None}
                c = int(r.count[j])
                m["count"] += c
                if r.sum is not None:
                    m["sum"] += r.sum[j].item() if hasattr(r.sum[j], "item") else r.sum[j]
                if c and r.min is not None:
                    m["min"] = r.min[j] if m["min"] is None else min(m["min"], r.min[j])
                if c and r.max is not None:
                    m["max"] = r.max[j] if m["max"] is None else max(m["max"], r.max[j])
        ks = sorted(merged)
        if ks and isinstance(ks[0], tuple):  # multi-key: an object array of tuples
            keys_arr = np.empty(len(ks), object)
            keys_arr[:] = ks
        else:
            keys_arr = np.array(ks)
        return GroupResult(
            keys=keys_arr,
            count=np.array([merged[k]["count"] for k in ks], np.int64),
            sum=np.array([merged[k]["sum"] for k in ks]) if "sum" in aggs else None,
            min=np.array([merged[k]["min"] if merged[k]["min"] is not None else 0 for k in ks]) if "min" in aggs else None,
            max=np.array([merged[k]["max"] if merged[k]["max"] is not None else 0 for k in ks]) if "max" in aggs else None,
        )

    def compact(self, out_path: str, *, rows_per_partition: int = 1 << 24, schemes=None,
                overwrite: bool = False) -> "Dataset":
        """Rewrite into evenly sized partitions (decode and re-encode with
        the advisor, or ``schemes``). Memory stays bounded by
        ``rows_per_partition`` plus one source partition."""
        from .nulls import is_nullable, valid_mask

        if os.path.abspath(out_path) == os.path.abspath(self.path):
            raise ValueError("compact to a different directory (source partitions are read lazily while writing)")
        names = self.names
        logical = {}
        if self.n_partitions:
            p0 = self.part(0)
            logical = {nm: p0[nm].params.get("logical") for nm in names}

        def retag(t: Table) -> Table:
            for nm, lg in logical.items():
                if lg:
                    t[nm].params = {**t[nm].params, "logical": lg}
            return t

        def chunks():
            vals: dict[str, list] = {nm: [] for nm in names}
            valid: dict[str, list] = {nm: [] for nm in names}
            nullable = {nm: False for nm in names}
            have = 0

            def emit(k: int) -> Table:
                nonlocal have
                arrays = {}
                for nm in names:
                    v = np.concatenate(vals[nm])
                    if nullable[nm]:
                        m = np.concatenate(valid[nm])
                        arrays[nm] = (v[:k], m[:k])
                        valid[nm] = [m[k:]]
                    else:
                        arrays[nm] = v[:k]
                        valid[nm] = []
                    vals[nm] = [v[k:]]
                have -= k
                return retag(Table.from_arrays(arrays, schemes, device=self.device))

            for i in range(self.n_partitions):
                t = self.part(i)
                rows = t.select(names)
                for nm in names:
                    c = t[nm]
                    vals[nm].append(rows[nm])
                    if is_nullable(c):
                        nullable[nm] = True
                        # backfill all-valid for the earlier partitions
                        prior = sum(x.shape[0] for x in vals[nm][:-1]) - sum(x.shape[0] for x in valid[nm])
                        if prior > 0:
                            valid[nm].append(np.ones(prior, bool))
                        valid[nm].append(valid_mask(c))
                    elif nullable[nm]:
                        valid[nm].append(np.ones(c.n, bool))
                have += t.n
                while have >= rows_per_partition:
                    yield emit(rows_per_partition)
            if have:
                yield emit(have)

        return Dataset.write(out_path, chunks(), overwrite=overwrite, device=self.device)

    def to_pandas(self, *predicates):
        import pandas as pd

        frames = []
        for i, verdict in self._scan_plan(predicates):
            if verdict == "skip":
                continue
            t = self.part(i)
            frames.append(t.to_pandas(t.where_all(*predicates) if predicates else None))
        if not frames:
            return pd.DataFrame(columns=self.names)
        return pd.concat(frames, ignore_index=True)
