"""Command-line entry of the PyTorch port (``giddy-tpu-torch``, or
``python -m giddy_tpu_torch.cli``): the subcommands of giddy_tpu/cli.py
with the same arguments and outputs, plus ``--device`` (default ``cuda``)
on every subcommand that decodes or scans.

Subcommands:
  gen       synth a column (per-scheme data shapes) -> .npy
  encode    .npy column -> .gtp container (scheme ``auto``: the advisor)
  pack      several .npy columns -> one container
  import    CSV/Parquet -> container or partitioned dataset (pandas)
  export    container -> CSV/Parquet (pandas)
  decode    .gtp container -> .npy (decode on the device; --ref for the oracle)
  validate  device decode vs the NumPy oracle, bit-exact, every column
  info      container header / ratios, or a dataset's manifest
  query     count (and select) the rows matching a predicate
  groupby   per-key aggregates over a dictionary-backed key column
  agg       one aggregate of a column
  bench     per-scheme throughput + roofline (runs bench_torch.py's main)

``decode --trace DIR`` writes a torch.profiler trace of the decode into
DIR. Beside the card's kernels it carries the port's own ``giddy.`` host
ranges (trace.py): the decoder's build, the streams' prep and upload, the
decode call and its kernel launch. PERF.md §3 lists every span.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .table import _host


def _load_cols(path: str):
    from .format import read_container

    with open(path, "rb") as f:
        return read_container(f.read())


def cmd_gen(args) -> None:
    from .datagen import gen_column

    rng = np.random.default_rng(args.seed)
    v = gen_column(args.scheme, args.n, rng)
    np.save(args.out, v)
    print(f"wrote {args.out}: {args.n} x {v.dtype} for scheme {args.scheme}")


def cmd_encode(args) -> None:
    from .api import encode
    from .format import write_container

    v = np.load(args.input)
    mask = None
    if args.valid:
        mask = np.load(args.valid).astype(bool)
        if mask.shape != v.shape:
            raise SystemExit(f"--valid mask shape {mask.shape} != data shape {v.shape}")
    if args.scheme == "auto":
        from .advisor import encode_best, suggest

        if mask is not None:
            from .nulls import fill_nulls

            v = fill_nulls(v, mask)  # advise on what actually gets encoded
        ranked = suggest(v, measure=args.measure, device=args.device)
        print("advisor:", ", ".join(f"{s}={r:.1f}x" for s, r in ranked[:4]))
        col = encode_best(v, name=args.name, ranked=ranked)
        if mask is not None:
            from .nulls import attach_valid

            col = attach_valid(col, mask)
    else:
        col = encode(v, args.scheme, name=args.name, valid=mask)
    with open(args.out, "wb") as f:
        write_container([col], f)
    print(f"{args.input} -> {args.out} [{col.scheme}]: {col.nbytes_decoded} -> "
          f"{col.nbytes_compressed} bytes ({col.ratio:.2f}x)")


def cmd_pack(args) -> None:
    """Build a multi-column container: each spec is name=scheme:file.npy
    (scheme 'auto' uses the advisor; 'strdict' loads a list via np.load
    allow_pickle or a unicode array)."""
    from .api import encode
    from .format import write_container

    cols = []
    for spec in args.columns:
        try:
            name, rest = spec.split("=", 1)
            scheme, path = rest.split(":", 1)
        except ValueError:
            raise SystemExit(f"bad column spec {spec!r}; want name=scheme:file.npy")
        v = np.load(path, allow_pickle=scheme == "strdict")
        if scheme == "strdict":
            from .strings import encode_strings

            cols.append(encode_strings(list(v), name=name))
        elif scheme == "auto":
            from .advisor import encode_best

            cols.append(encode_best(v, name=name))
        else:
            cols.append(encode(v, scheme, name=name))
    with open(args.out, "wb") as f:
        write_container(cols, f)
    total_dec = sum(c.nbytes_decoded for c in cols)
    total_cmp = sum(c.nbytes_compressed for c in cols)
    print(f"{len(cols)} columns -> {args.out}: {total_dec} -> {total_cmp} bytes")


def cmd_import(args) -> None:
    """CSV/Parquet file -> container (Table.from_pandas: advisor-picked
    schemes, 64-bit via wide, strings to strdict, NA -> null rows)."""
    import pandas as pd

    from .table import Table

    schemes = {}
    for spec in args.scheme or []:
        try:
            name, scheme = spec.split("=", 1)
        except ValueError:
            raise SystemExit(f"bad --scheme spec {spec!r}; want name=scheme")
        schemes[name] = scheme
    if args.partitioned:
        if args.file.endswith((".parquet", ".pq")):
            raise SystemExit("--partitioned streams CSV input only")
        from .dataset import Dataset

        ds = Dataset.from_csv(args.out, args.file, schemes=schemes, rows_per_partition=args.rows_per_partition,
                              device=args.device)
        print(f"{args.file} -> {args.out}: {ds.n_partitions} partitions x "
              f"<= {args.rows_per_partition} rows, {len(ds)} total")
        return
    df = pd.read_parquet(args.file) if args.file.endswith((".parquet", ".pq")) else pd.read_csv(args.file)
    t = Table.from_pandas(df, schemes=schemes, device=args.device)
    t.save(args.out)
    total_dec = sum(t[nm].nbytes_decoded for nm in t.names)
    total_cmp = sum(t[nm].nbytes_compressed for nm in t.names)
    picks = ", ".join(f"{nm}={t[nm].scheme}" for nm in t.names)
    print(f"{args.file} -> {args.out}: {len(t.names)} columns x {t.n} rows, "
          f"{total_dec} -> {total_cmp} bytes ({picks})")


def cmd_export(args) -> None:
    """Container -> CSV/Parquet via Table.to_pandas (nulls become NA)."""
    from .table import Table

    df = Table.open(args.file, device=args.device).to_pandas()
    if args.out.endswith((".parquet", ".pq")):
        df.to_parquet(args.out, index=False)
    else:
        df.to_csv(args.out, index=False)
    print(f"{args.file} -> {args.out}: {len(df.columns)} columns x {len(df)} rows")


def cmd_decode(args) -> None:
    from .api import decode, decode_ref

    col = _load_cols(args.input)[args.column]
    if args.ref:
        out = decode_ref(col)
    else:
        with _trace_ctx(args):
            out = _host(decode(col, device=args.device))
    np.save(args.out, out)
    print(f"decoded {col.name} ({col.scheme}): {col.n} values -> {args.out}")


def cmd_validate(args) -> None:
    from .api import decode, decode_ref

    failures = 0
    for col in _load_cols(args.input):
        ref = decode_ref(col)
        dev = _host(decode(col, device=args.device))
        ok = np.array_equal(ref, dev)
        print(f"{col.name:24s} {col.scheme:8s} n={col.n:<12d} {'BIT-EXACT' if ok else 'MISMATCH'}")
        failures += not ok
    sys.exit(1 if failures else 0)


def cmd_query(args) -> None:
    """Predicate pushdown straight off the compressed container: only the
    1-bit-per-element match bitmap materializes (on the device)."""
    from .query import between_bitmap, count_bits, filter_bitmap
    from .util import np_dtype

    col = _load_cols(args.input)[args.column]
    parse = float if np_dtype(col.dtype).kind == "f" else int
    if args.between is not None:
        lo, hi = (parse(x) for x in args.between)
        bm, label = between_bitmap(col, lo, hi, device=args.device), f"{lo} <= x <= {hi}"
    else:
        if args.value is None:
            sys.exit("giddy-tpu-torch query: need --value N (or --between LO HI)")
        bm, label = filter_bitmap(col, args.op, parse(args.value), device=args.device), f"x {args.op} {args.value}"
    cnt = count_bits(bm, col.n)
    out = {
        "column": col.name, "scheme": col.scheme, "predicate": label,
        "count": cnt, "n": col.n, "selectivity": round(cnt / max(col.n, 1), 6),
    }
    if args.select is not None:
        from .query import select

        np.save(args.select, select(col, bm, device=args.device))
        out["selected"] = args.select
    print(json.dumps(out))


def cmd_groupby(args) -> None:
    """GROUP BY over the compressed container: keys from a dictionary-
    backed column, an optional measure and an optional filter column."""
    from .groupby import group_reduce
    from .query import filter_bitmap
    from .util import np_dtype

    cols = _load_cols(args.input)
    keys = cols[args.keys]
    vals = cols[args.vals] if args.vals is not None else None
    aggs = tuple(a.strip() for a in args.aggs.split(","))
    bm = None
    if args.where is not None:
        if args.value is None:
            sys.exit("giddy-tpu-torch groupby: --where needs --value N (and --op)")
        wcol = cols[args.where]
        parse = float if np_dtype(wcol.dtype).kind == "f" else int
        bm = filter_bitmap(wcol, args.op, parse(args.value), device=args.device)
    r = group_reduce(keys, vals, aggs, bitmap=bm, device=args.device)
    for i in range(len(r.keys)):
        row = {"key": r.keys[i].item(), "count": int(r.count[i])}
        if r.sum is not None:
            s = r.sum[i]
            row["sum"] = s.item() if hasattr(s, "item") else s
        if r.count[i]:
            if r.min is not None:
                row["min"] = r.min[i].item()
            if r.max is not None:
                row["max"] = r.max[i].item()
        print(json.dumps(row))


def cmd_agg(args) -> None:
    from .aggregate import avg_, distinct_count, max_, min_, sum_
    from .nulls import count_valid

    col = _load_cols(args.input)[args.column]
    if args.agg == "count":
        value = count_valid(col)
    else:
        fn = {"sum": sum_, "min": min_, "max": max_, "avg": avg_, "distinct": distinct_count}[args.agg]
        value = fn(col, device=args.device)
    print(json.dumps({"column": col.name, "scheme": col.scheme, "agg": args.agg, "value": value, "n": col.n}))


def cmd_info(args) -> None:
    from .nulls import is_nullable, null_count

    if os.path.isdir(args.input):  # a partitioned dataset directory
        from .dataset import Dataset

        ds = Dataset.open(args.input)
        print(json.dumps({
            "dataset": args.input,
            "rows": len(ds),
            "partitions": ds.n_partitions,
            "columns": ds.names,
            "dtypes": ds.manifest.get("dtypes", {}),
            "zones": {p["file"]: p["zones"] for p in ds.manifest["partitions"]},
        }))
        return
    for col in _load_cols(args.input):
        info = {
            "name": col.name, "scheme": col.scheme, "dtype": col.dtype,
            "n": col.n, "params": col.params,
            "compressed_bytes": col.nbytes_compressed,
            "decoded_bytes": col.nbytes_decoded,
            "ratio": round(col.ratio, 3),
            "streams": {k: list(v.shape) for k, v in col.streams.items()},
        }
        if is_nullable(col):
            info["nulls"] = null_count(col)
        print(json.dumps(info))


def cmd_bench(args) -> None:
    """bench_torch.py's main with these options. The script lives at the
    checkout's root; it is imported as ``bench_torch`` once a process."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "bench_torch.py"
    if not path.exists():
        sys.exit(
            "giddy-tpu-torch bench needs the repository checkout (bench_torch.py lives at "
            "the repo root and is not shipped in the wheel); run it from a clone, or use "
            "the library API with giddy_tpu_torch.roofline directly."
        )
    mod = sys.modules.get("bench_torch")
    if mod is None or pathlib.Path(mod.__file__).resolve() != path:
        spec = importlib.util.spec_from_file_location("bench_torch", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bench_torch"] = mod
        spec.loader.exec_module(mod)
    mod.main(["--n", str(args.n), "--iters", str(args.iters), "--schemes", args.schemes, "--device", args.device])


def _trace_ctx(args):
    """A torch.profiler trace of the block into ``--trace DIR`` (the CPU
    activity, and the card's where the device is CUDA)."""
    import contextlib

    if not getattr(args, "trace", None):
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(args.device).type == "cuda" else [])
    return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(args.trace))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="giddy-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp) -> None:
        sp.add_argument("--device", default="cuda", help="device to decode and scan on (cuda or cpu)")

    g = sub.add_parser("gen")
    g.add_argument("scheme")
    g.add_argument("--n", type=int, default=1 << 20)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", default="column.npy")
    g.set_defaults(fn=cmd_gen)

    e = sub.add_parser("encode")
    e.add_argument("input")
    e.add_argument("scheme")
    e.add_argument("--name", default="col")
    e.add_argument("--valid", default=None, metavar="MASK.npy",
                   help="bool mask (True = non-null): encode a nullable column")
    e.add_argument("--out", default="column.gtp")
    e.add_argument("--measure", action="store_true",
                   help="with scheme=auto: settle near-ties by measured decode throughput on --device")
    device_arg(e)
    e.set_defaults(fn=cmd_encode)

    im = sub.add_parser("import", help="CSV/Parquet -> container (advisor-picked schemes)")
    im.add_argument("file")
    im.add_argument("--out", required=True)
    im.add_argument("--scheme", action="append", metavar="NAME=SCHEME",
                    help="override the advisor for a column (repeatable)")
    im.add_argument("--partitioned", action="store_true",
                    help="stream a CSV into a partitioned dataset directory")
    im.add_argument("--rows-per-partition", type=int, default=1 << 22)
    device_arg(im)
    im.set_defaults(fn=cmd_import)

    ex = sub.add_parser("export", help="container -> CSV/Parquet")
    ex.add_argument("file")
    ex.add_argument("--out", required=True)
    device_arg(ex)
    ex.set_defaults(fn=cmd_export)

    pk = sub.add_parser("pack", help="build a multi-column container from .npy files")
    pk.add_argument("columns", nargs="+", metavar="name=scheme:file.npy")
    pk.add_argument("--out", default="table.gtp")
    pk.set_defaults(fn=cmd_pack)

    d = sub.add_parser("decode")
    d.add_argument("input")
    d.add_argument("--column", type=int, default=0)
    d.add_argument("--ref", action="store_true")
    d.add_argument("--trace", default=None, metavar="DIR", help="write a torch.profiler trace of the decode here")
    d.add_argument("--out", default="decoded.npy")
    device_arg(d)
    d.set_defaults(fn=cmd_decode)

    v = sub.add_parser("validate")
    v.add_argument("input")
    device_arg(v)
    v.set_defaults(fn=cmd_validate)

    i = sub.add_parser("info")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    q = sub.add_parser("query", help="count rows matching a predicate, without decoding")
    q.add_argument("input")
    q.add_argument("--column", type=int, default=0)
    q.add_argument("--op", default="eq", choices=("eq", "ne", "lt", "le", "gt", "ge"))
    q.add_argument("--value", default=None)
    q.add_argument("--between", nargs=2, metavar=("LO", "HI"), default=None)
    q.add_argument("--select", default=None, metavar="OUT.npy",
                   help="also materialize the matching values (decodes only groups with matches)")
    device_arg(q)
    q.set_defaults(fn=cmd_query)

    gb = sub.add_parser("groupby", help="per-key aggregates over a dictionary-backed key column")
    gb.add_argument("input")
    gb.add_argument("--keys", type=int, default=0, help="key column index (dict/cascade/strdict scheme)")
    gb.add_argument("--vals", type=int, default=None, help="measure column index")
    gb.add_argument("--aggs", default="count", help="comma list of count,sum,min,max")
    gb.add_argument("--where", type=int, default=None, help="filter column index")
    gb.add_argument("--op", default="eq", choices=("eq", "ne", "lt", "le", "gt", "ge"))
    gb.add_argument("--value", default=None)
    device_arg(gb)
    gb.set_defaults(fn=cmd_groupby)

    a = sub.add_parser("agg", help="fused aggregate (sum/min/max) without decoding")
    a.add_argument("input")
    a.add_argument("agg", choices=("sum", "min", "max", "avg", "count", "distinct"))
    a.add_argument("--column", type=int, default=0)
    device_arg(a)
    a.set_defaults(fn=cmd_agg)

    b = sub.add_parser("bench")
    b.add_argument("--n", type=int, default=26)
    b.add_argument("--iters", type=int, default=10)
    b.add_argument("--schemes", default="nbit,for,delta,dict,rle")
    device_arg(b)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except (ValueError, FileNotFoundError) as e:
        # KeyError etc. are internal bugs: let those traceback
        sys.exit(f"giddy-tpu-torch: error: {e}")


if __name__ == "__main__":
    main()
