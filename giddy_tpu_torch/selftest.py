"""``python -m giddy_tpu_torch.selftest``: one-shot device-vs-oracle proof
of the port.

Counterpart of giddy_tpu/selftest.py. Decodes every core scheme
(datagen.CORE_SCHEMES) on the device, compares bit for bit with the NumPy
oracle and runs the traffic audit of each (roofline.traffic_audit: the
decoder's temporary bytes and its traffic against the ideal and against
speed of light, held on the card to the reference's TRAFFIC_CAP), then
runs the composite checks (64-bit, string, nullable and mixed columns,
dense runs, a big dictionary, narrow stores, whose audited output is 1 or
2 bytes a value) and the query layer's (filters,
with the column-vs-column compare and a searched isin of more than 8
values; aggregates; GROUP BY; top-k; joins; zone maps; partitioned
datasets), each against NumPy, and prints ONE JSON line. The reference's
``xor_mxu`` check (a TPU MXU path) has no counterpart here (ROADMAP.md,
"Do not port").

Exit code 0 = every scheme and check exact; 1 = any mismatch or error.
Runs on the card unless ``--device cpu`` is asked.
"""

from __future__ import annotations

import argparse
import json
import operator
import pathlib
import sys
import time
import traceback

import numpy as np
import torch

from .datagen import CORE_SCHEMES as SCHEMES
from .table import _host

# The single-pass ceiling of the reference: a decoder's traffic over the
# compressed plus decoded bytes (the audit's traffic_vs_sol) must stay at
# or under this; a ratio r caps the decode at 1/r of speed of light.
TRAFFIC_CAP = 1.15

_NP_OP = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
          "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}


def _expect(ok, what) -> None:
    """Raise on a failed check (``assert`` would vanish under -O)."""
    if not ok:
        raise AssertionError(what)


def run_selftest(n: int, seed: int = 0, *, device: torch.device | str = "cuda", audit: bool = True) -> dict:
    """Every core scheme and every check at ``n`` values on ``device``, and
    with ``audit`` each core scheme's traffic audit (``temp_bytes``,
    ``traffic_vs_ideal``, ``traffic_vs_sol``; None on the CPU, where torch
    keeps no allocator statistics). Returns the report; ``report["pass"]``
    is True only when every entry is exact. A check that raises is recorded
    as a failure with its error. Where the audit measured ratios (on the
    card), ``report["traffic_ok"]`` says whether every core scheme's
    ``traffic_vs_sol`` is at or under TRAFFIC_CAP, and the schemes over it
    are printed to stderr; ``pass`` does not read it, as in the reference.
    On the CPU the report has no ``traffic_ok``."""
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch.api import _decode_device
    from giddy_tpu_torch.datagen import gen_column
    from giddy_tpu_torch.roofline import traffic_audit

    device = _decode_device(device)
    rng = np.random.default_rng(seed)
    report: dict = {
        "device": device.type,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "n": n,
        "schemes": {},
    }
    ok = True
    for scheme in SCHEMES:
        entry: dict = {}
        try:
            v = gen_column(scheme, n, rng)
            col = gtt.encode(v, scheme, name=f"selftest_{scheme}")
            t0 = time.perf_counter()
            out = _host(gtt.decode(col, device=device))
            entry["decode_s"] = round(time.perf_counter() - t0, 3)
            entry["exact"] = bool(out.tobytes() == gtt.decode_ref(col).tobytes())
            if audit:
                a = traffic_audit(col, device)
                entry["temp_bytes"] = a["temp_bytes"]
                entry["traffic_vs_ideal"] = None if a["ratio"] is None else round(a["ratio"], 4)
                entry["traffic_vs_sol"] = None if a["sol_ratio"] is None else round(a["sol_ratio"], 4)
        except Exception as e:  # the report's boundary: recorded, and the run fails
            entry["error"] = f"{type(e).__name__}: {e}"
            entry["traceback"] = traceback.format_exc()
            entry["exact"] = False
        ok = ok and entry["exact"]
        report["schemes"][scheme] = entry
        print(f"[selftest] {scheme:9s} " + ("EXACT" if entry["exact"] else f"FAIL {entry.get('error', '')}"),
              file=sys.stderr)
    for name, fn in CHECKS:
        entry = {}
        try:
            t0 = time.perf_counter()
            fn(n, rng, device)
            entry["s"] = round(time.perf_counter() - t0, 3)
            entry["exact"] = True
        except Exception as e:  # the report's boundary: recorded, and the run fails
            entry["error"] = f"{type(e).__name__}: {e}"
            entry["traceback"] = traceback.format_exc()
            entry["exact"] = False
        ok = ok and entry["exact"]
        report["schemes"][name] = entry
        print(f"[selftest] {name:15s} " + ("EXACT" if entry["exact"] else f"FAIL {entry.get('error', '')}"),
              file=sys.stderr)
    # drift guard: every registered device-decodable scheme is covered
    from giddy_tpu_torch import registry

    covered = set(SCHEMES) | {"wide", "strdict"}
    uncovered = [s for s in registry.schemes() if registry.get(s).decode_device is not None and s not in covered]
    if uncovered:
        report["uncovered_schemes"] = uncovered
        print(f"[selftest] UNCOVERED registered schemes: {uncovered}", file=sys.stderr)
        ok = False
    report["pass"] = ok
    measured = {s: e["traffic_vs_sol"] for s, e in report["schemes"].items() if e.get("traffic_vs_sol") is not None}
    if measured:
        bad = {s: r for s, r in measured.items() if r > TRAFFIC_CAP}
        report["traffic_ok"] = not bad
        if bad:
            print(f"[selftest] traffic over {TRAFFIC_CAP}x SoL bytes: {bad}", file=sys.stderr)
    return report


def _check_wide(n, rng, device):
    import giddy_tpu_torch as gtt

    v = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    _expect((_host(gtt.decode(gtt.encode(v, "wide"), device=device)) == v).all(), "wide")


def _check_strdict(n, rng, device):
    from giddy_tpu_torch import strings

    vocab = [f"name_{i}".encode() for i in range(97)]
    vals = [vocab[i] for i in rng.integers(0, len(vocab), n)]
    out = strings.decode(strings.encode_strings(vals, name="st"), device=device)
    _expect(list(out) == vals, "strdict")


def _check_nullable(n, rng, device):
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import nulls

    v = rng.integers(0, 1000, n, dtype=np.int64).astype(np.int32)
    mask = rng.random(n) >= 0.1
    col = gtt.encode(v, "nbit", valid=mask)
    _expect(nulls.null_count(col) == int((~mask).sum()), "null count")
    out = _host(gtt.decode(col, device=device))
    _expect((out[mask] == v[mask]).all(), "nullable values")


def _check_mixed(n, rng, device):
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch.datagen import gen_column

    cols = [gtt.encode(gen_column(s, n // 2, rng), s, name=f"mix_{s}") for s in ("delta", "dict", "rle", "patched")]
    outs = gtt.decode_columns(cols, device=device)
    for c in cols:
        _expect((_host(outs[c.name]) == gtt.decode_ref(c)).all(), c.name)


def _check_big_dict(n, rng, device):
    """A 16k-entry dictionary (strdict's realistic regime): past the
    shared-memory table of K4, the dictionary gather reads global memory."""
    import giddy_tpu_torch as gtt

    d = 16384
    vocab = rng.integers(-(2**31), 2**31 - 1, d, dtype=np.int64).astype(np.int32)
    v = vocab[rng.integers(0, d, n)]
    col = gtt.encode(v, "dict")
    _expect(col.params["dict_size"] > 2048, "want a big dictionary")
    _expect((_host(gtt.decode(col, device=device)) == v).all(), "big dict")


def _check_rle_dense(n, rng, device):
    """Mid-density runs (length ~4-12): the run expansion at its largest
    tables, and the scatter form, also under cascade's dictionary."""
    import giddy_tpu_torch as gtt

    for rl in (5, 12):
        v = (np.arange(n, dtype=np.int64) // rl).astype(np.int32) % 50000
        _expect((_host(gtt.decode(gtt.encode(v, "rle"), device=device)) == v).all(), f"rle run-length {rl}")
    base = (np.arange(n // 8, dtype=np.int64) % 900).astype(np.int32)
    v = np.repeat(base, 8)[:n]
    out = _host(gtt.decode(gtt.encode(v, "cascade", codes_scheme="rle"), device=device))
    _expect((out == v).all(), "cascade(rle) table")


def _check_narrow_store(n, rng, device):
    """int8/int16 columns decode into storage-width outputs: the decoder's
    padded output, and the traffic audit's ``out_bytes``, is 1 or 2 bytes a
    value and the values bit-exact."""
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch.roofline import traffic_audit
    from giddy_tpu_torch.util import GROUP

    cases = [
        ("nbit", rng.integers(0, 200, n).astype(np.uint8)),
        ("for", rng.integers(0, 60000, n).astype(np.uint16)),
        ("delta", np.minimum(np.arange(n) // 600, 100).astype(np.int16)),
        ("dict", rng.integers(-100, 100, n).astype(np.int8)),
        ("rle", (np.arange(n) // 700).astype(np.int16)),
        ("rle", ((np.arange(n) // 5) % 30000).astype(np.int16)),
        ("dzbv", rng.integers(0, 60000, n).astype(np.uint16)),
        ("bitmap", (rng.integers(0, 4, n) * 7).astype(np.uint8)),
        ("patched", np.where(rng.random(n) < 0.002, 30000, rng.integers(0, 60, n)).astype(np.int16)),
    ]
    base = (np.arange(n // 8, dtype=np.int64) % 90).astype(np.int16)
    cases.append(("cascade", np.repeat(base, 8)[:n]))
    for scheme, v in cases:
        opts = {"codes_scheme": "rle"} if scheme == "cascade" else {}
        col = gtt.encode(v, scheme, **opts)
        n_pad = -(-v.shape[0] // GROUP) * GROUP
        padded = gtt.decode(col, device=device, pad=True)
        _expect(padded.element_size() == v.dtype.itemsize, f"narrow {scheme}: {padded.dtype} store")
        _expect(padded.numel() == n_pad, f"narrow {scheme}: padded length")
        out = _host(padded[: v.shape[0]])
        _expect(out.dtype == v.dtype and (out == v).all(), f"narrow {scheme}")
        a = traffic_audit(col, device)
        _expect(a["out_bytes"] == n_pad * v.dtype.itemsize, f"narrow {scheme}: audited {a}")
    nb = 40 * GROUP + 13  # many groups at a narrow store
    vb = rng.integers(0, 200, nb).astype(np.uint8)
    colb = gtt.encode(vb, "nbit")
    outb = _host(gtt.decode(colb, device=device))
    _expect(outb.dtype == vb.dtype and (outb == vb).all(), "narrow multi-block")
    ab = traffic_audit(colb, device)
    _expect(ab["out_bytes"] == 41 * GROUP, f"narrow multi-block store: audited {ab}")


def _check_query_filters(n, rng, device):
    """Filter bitmaps for every op on an int32 delta, a float32 alp and an
    int16 nbit column, select_where, isin with 3 values and with more than
    8 (the search on the card), and the column-vs-column compare at every
    op, vs NumPy."""
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import query

    vi = np.cumsum(rng.integers(-3, 4, n)).astype(np.int32)
    vf = (rng.integers(0, 2000, n) / 100.0).astype(np.float32)
    vn = rng.integers(-300, 300, n).astype(np.int16)
    for v, scheme in ((vi, "delta"), (vf, "alp"), (vn, "nbit")):
        col = gtt.encode(v, scheme)
        pivot = v[n // 2]
        for op in _NP_OP:
            got = query.count_where(col, op, pivot, device=device)
            want = int(_NP_OP[op](v, pivot).sum())
            _expect(got == want, (scheme, op, got, want))
    col = gtt.encode(vi, "delta")
    pivot = int(vi[n // 3])
    _expect((query.select_where(col, "ge", pivot, device=device) == vi[vi >= pivot]).all(), "select_where")
    for vals in ([int(vi[1]), int(vi[7]), 10**9], [int(x) for x in vi[:: max(1, n // 40)][:40]] + [10**9]):
        got = query.count_bits(query.isin_bitmap(col, vals, device=device), n)
        _expect(got == int(np.isin(vi, vals).sum()), ("isin", len(vals), got))
    w = vi + rng.integers(-2, 3, n).astype(np.int32)
    other = gtt.encode(w, "delta")
    for op in _NP_OP:
        got = query.count_where_cols(col, other, op, device=device)
        _expect(got == int(_NP_OP[op](vi, w).sum()), ("filter_bitmap_cols", op, got))


def _check_aggregates(n, rng, device):
    """Exact sum/min/max and distinct on int32, int16 and float32 columns."""
    import math

    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import aggregate as ag

    vi = rng.integers(-(10**6), 10**6, n).astype(np.int32)
    vf = (rng.standard_normal(n) * 100).astype(np.float32)
    vn = rng.integers(0, 500, n).astype(np.int16)
    for v, scheme in ((vi, "nbit"), (vf, "xordelta"), (vn, "for")):
        col = gtt.encode(v, scheme)
        s = ag.sum_(col, device=device)
        if v.dtype.kind == "f":
            _expect(math.isclose(s, float(np.sum(v, dtype=np.float64)), rel_tol=1e-9), scheme)
        else:
            _expect(s == int(v.astype(np.int64).sum()), scheme)
        _expect(ag.min_(col, device=device) == v.min() and ag.max_(col, device=device) == v.max(), scheme)
    _expect(ag.distinct_count(gtt.encode(vn, "dict"), device=device) == len(np.unique(vn)), "distinct")


def _check_groupby(n, rng, device):
    """Per-key count/sum/min/max over dict keys, plain and under a filter
    bitmap."""
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import groupby as gb
    from giddy_tpu_torch import query

    keys = rng.integers(0, 37, n).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    kcol, vcol = gtt.encode(keys, "dict"), gtt.encode(vals, "nbit")
    r = gb.group_reduce(kcol, vcol, aggs=("count", "sum", "min", "max"), device=device)
    for i, k in enumerate(r.keys):
        m = keys == int(k)
        _expect(int(r.count[i]) == int(m.sum()) and int(r.sum[i]) == int(vals[m].astype(np.int64).sum())
                and int(r.min[i]) == int(vals[m].min()) and int(r.max[i]) == int(vals[m].max()), ("group", k))
    bm = query.filter_bitmap(vcol, "ge", 0, device=device)
    r2 = gb.group_reduce(kcol, vcol, aggs=("count",), bitmap=bm, device=device)
    for i, k in enumerate(r2.keys):
        _expect(int(r2.count[i]) == int(((vals >= 0) & (keys == int(k))).sum()), ("filtered group", k))


def _check_topk(n, rng, device):
    """top_k largest and smallest, and argmax."""
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import topk

    v = rng.integers(-(10**8), 10**8, n).astype(np.int32)
    col = gtt.encode(v, "nbit")
    tv, tp = topk.top_k(col, 5, device=device)
    want = np.sort(v)[::-1][:5]
    _expect((tv == want).all() and (v[tp] == want).all(), ("top_k", tv, want))
    sv, _ = topk.top_k(col, 5, largest=False, device=device)
    _expect((sv == np.sort(v)[:5]).all(), "top_k smallest")
    _expect(v[topk.argmax_(col, device=device)] == v.max(), "argmax")


def _check_join(n, rng, device):
    """Membership prunes on the device and the host sort-merge equi-join,
    vs a NumPy join's pair count."""
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import join

    left = rng.integers(0, n // 2, n).astype(np.int32)
    right = rng.integers(n // 4, n, n // 3).astype(np.int32)
    li, ri = join.join_indices(gtt.encode(left, "nbit"), gtt.encode(right, "nbit"), device=device)
    _expect((left[li] == right[ri]).all(), "join keys")
    common = np.intersect1d(left, right)
    lc = np.bincount(left[np.isin(left, common)], minlength=n)
    rc = np.bincount(right[np.isin(right, common)], minlength=n)
    _expect(li.shape[0] == int((lc.astype(np.int64) * rc.astype(np.int64)).sum()), "join pair count")


def _check_zonemap(n, rng, device):
    """Zone-map pruned count on clustered data (the undecided groups alone
    decode)."""
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import zonemap

    v = (np.arange(n, dtype=np.int64) // 977 * 10).astype(np.int32)
    v += rng.integers(0, 10, n).astype(np.int32)
    col = gtt.encode(v, "delta")
    pivot = int(v[n // 3])
    _expect(zonemap.count_where_pruned(col, "lt", pivot, device=device) == int((v < pivot).sum()), "pruned count")


def _check_dataset(n, rng, device):
    """A two-partition dataset: manifest pruning, count/agg/groupby."""
    import shutil
    import tempfile

    from giddy_tpu_torch.dataset import Dataset
    from giddy_tpu_torch.table import Table

    k1 = rng.integers(0, 9, n).astype(np.int32)
    x1 = rng.integers(0, 1000, n).astype(np.int32)
    k2 = rng.integers(0, 9, n).astype(np.int32)
    x2 = rng.integers(5000, 9000, n).astype(np.int32)
    t1 = Table.from_arrays({"k": k1, "x": x1}, schemes={"k": "dict"}, device=device)
    t2 = Table.from_arrays({"k": k2, "x": x2}, schemes={"k": "dict"}, device=device)
    d = tempfile.mkdtemp(prefix="gtt_selftest_ds_")
    try:
        ds = Dataset.write(d + "/ds", [t1, t2], device=device)
        _expect(ds.count(("x", "ge", 5000)) == int((x1 >= 5000).sum() + (x2 >= 5000).sum()), "dataset count")
        _expect(ds.agg("x", "min") == int(min(x1.min(), x2.min())), "dataset min")
        _expect(ds.agg("x", "max") == int(max(x1.max(), x2.max())), "dataset max")
        g = ds.groupby("k", "x", ("sum",))
        allk, allx = np.concatenate([k1, k2]), np.concatenate([x1, x2]).astype(np.int64)
        for k, s in zip(g.keys, g.sum):
            _expect(int(s) == int(allx[allk == int(k)].sum()), ("dataset group", k))
    finally:
        shutil.rmtree(d, ignore_errors=True)


# The composite and query-layer checks, in the reference's order (its
# xor_mxu excepted).
CHECKS = (
    ("wide", _check_wide),
    ("strdict", _check_strdict),
    ("nullable", _check_nullable),
    ("mixed_container", _check_mixed),
    ("rle_dense", _check_rle_dense),
    ("big_dict", _check_big_dict),
    ("narrow_store", _check_narrow_store),
    ("query_filters", _check_query_filters),
    ("query_aggregates", _check_aggregates),
    ("query_groupby", _check_groupby),
    ("query_topk", _check_topk),
    ("query_join", _check_join),
    ("query_zonemap", _check_zonemap),
    ("query_dataset", _check_dataset),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m giddy_tpu_torch.selftest")
    ap.add_argument("--n", type=int, default=(1 << 22) + 999,
                    help="elements per column (default ~4.2M: 129 groups, the last one ragged)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    report = run_selftest(args.n, args.seed, device=args.device)
    line = json.dumps(report)
    print(line)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
