#!/usr/bin/env python
"""Decode throughput benchmark of the PyTorch port: bench.py's protocol on
one CUDA device (``--device cpu`` runs the kernels' plain versions).

Prints ONE JSON line: the geometric-mean decode GB/s across the five
headline schemes (RLE/FOR/delta/dict/NBit — BASELINE.json "metric"),
`vs_baseline` = ratio to the DaMoN'17 reference recollections in
BASELINE.md (order-of-magnitude anchors: NBit/FOR/dict ≈ 65 GB/s,
delta/RLE ≈ 35 GB/s decoded on a Pascal GPU). Per-scheme detail goes to
stderr and results/torch/bench_detail.json.

A scheme's time is bench.py's: the host clock around batches of four calls
of its cached decoder on resident streams, through
``torch.cuda.synchronize``, median of the batches. It includes the Python
wrapper and each launch, so at small columns it is not the kernel's time
(chip_smoke.py times the kernels with CUDA events).

Usage:
  python bench_torch.py [--n LOG2] [--schemes a,b,c|all] [--iters K] [--mixed]
                        [--dist] [--dist-sweep] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from giddy_tpu_torch import api, dist, roofline  # noqa: E402
from giddy_tpu_torch.datagen import CORE_SCHEMES as ALL  # noqa: E402  (single source of truth)
from giddy_tpu_torch.datagen import gen_column  # noqa: E402
from giddy_tpu_torch.util import GROUP  # noqa: E402

# Where every run writes its records (bench.py writes results/).
RESULTS = pathlib.Path(__file__).resolve().parent / "results" / "torch"

# Reference throughput recollections (GB/s decoded) of the DaMoN'17 decoders
# on a Pascal GPU (BASELINE.md): anchors from memory, not measurements.
REF_GBPS = {
    "nbit": 65.0, "for": 65.0, "dict": 65.0, "dzbf": 65.0,
    "delta": 35.0, "delta2": 35.0, "rle": 35.0, "rpe": 35.0, "dzbv": 35.0,
    "model": 50.0, "bitmap": 50.0, "patched": 50.0, "raw": 100.0, "xordelta": 35.0,
    "cascade": 35.0,  # ~ dict gather atop an rle decode
    "alp": 65.0,  # FOR-shaped decode + a float op (no reference analog)
}
HEADLINE = ["nbit", "for", "delta", "dict", "rle"]
# Shard counts of --dist-sweep, one fresh process a point.
SWEEP = (1, 2, 4, 8)
# bench.py's options that this port refuses, and why.
NOT_PORTED = {
    "--scan-ab": "it A/Bs the reference's GIDDY_TPU_SCAN/GIDDY_TPU_XOR switches between its MXU and "
                 "pltpu.roll scans, which the port does not have (ROADMAP.md \"Do not port\": bench.py --scan-ab)",
    "--ab-trials": "the trial count of --scan-ab (ROADMAP.md \"Do not port\": bench.py --scan-ab)",
}


def _sync(devices) -> None:
    """Wait for every CUDA device of ``devices`` (the CPU runs in order)."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _median_time(run, iters: int, devices, batch: int = 4) -> float:
    """Median of per-batch timings after warmup — the device shows large
    run-to-run variance, so a single mean is not trustworthy."""
    for _ in range(3):
        run()
        _sync(devices)
    times = []
    for _ in range(max(iters, 5)):
        t0 = time.perf_counter()
        for _ in range(batch):
            run()
        _sync(devices)
        times.append((time.perf_counter() - t0) / batch)
    times.sort()
    return times[len(times) // 2]


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def prepare_scheme(scheme: str, n: int, rng, device="cuda"):
    """Encode, upload and warm up (NOT timed): the column and ``run``, its
    cached decoder on its streams resident on ``device``."""
    device = torch.device(device)
    if scheme == "rle_dense":
        # runs of ~1: rle's scatter form (scatter-add, then K6's group
        # prefix sum); the common long-run column decodes through K5
        v = gen_column("rle", n, rng, hard=True)
        col = api.encode(v, "rle", name="bench_rle_dense")
    elif scheme == "xordelta_narrow":
        # few active bit planes: the reference's MXU parity-scan regime,
        # here one more column for K8
        v = (np.cumsum(rng.integers(0, 3, n)) % 7).astype(np.int32).view(np.float32)
        col = api.encode(v, "xordelta", name="bench_xor_narrow")
    else:
        v = gen_column(scheme, n, rng)
        col = api.encode(v, scheme, name=f"bench_{scheme}")
    fn = api.get_decoder(col)
    streams = api.device_streams(col, device)
    fn(streams)
    _sync([device])
    return col, (lambda: fn(streams))


def time_prepared(col, run, scheme: str, iters: int, device="cuda") -> dict:
    device = torch.device(device)
    t = _median_time(run, iters, [device])
    touched = (col.nbytes_compressed + col.nbytes_decoded) / 1e9
    kind = _device_kind(device)
    try:
        rf = roofline.column_roofline(col, kind)
        sol, sol_gbps = rf.sol_fraction(t), rf.sol_decode_gbps
    except ValueError:  # no memory rate known for this device (the CPU)
        sol = sol_gbps = None
    return {
        "device_kind": kind,
        "decode_GBps": col.nbytes_decoded / 1e9 / t,
        "ratio": col.ratio,
        "hbm_touched_GBps": touched / t,
        "time_s": t,
        "vs_ref": col.nbytes_decoded / 1e9 / t / REF_GBPS.get(scheme, 50.0),
        # SoL fraction vs the card's published memory rate (>=0.8 is the
        # BASELINE target)
        "sol_fraction": sol,
        "sol_decode_GBps": sol_gbps,
    }


def _prepare_set(cols: list, stores: list, device: torch.device):
    """The columns' cached decoders, back to back on their resident
    streams with no host synchronisation between them, warmed up once."""
    decoders = [api.get_decoder(c, s) for c, s in zip(cols, stores)]
    streams = [api.device_streams(c, device) for c in cols]

    def run():
        return [d(s) for d, s in zip(decoders, streams)]

    run()
    _sync([device])
    return cols, run


def prepare_mixed(n: int, rng, device="cuda"):
    """Mixed TPC-H-style column set (BASELINE configs[4]): the columns and
    ``run``, their four decoders back to back."""
    cols = [
        api.encode(gen_column(s, n // 4, rng), s, name=f"mix_{s}")
        for s in ("delta", "dict", "rle", "patched")
    ]
    return _prepare_set(cols, [torch.int32] * len(cols), torch.device(device))


def bench_mixed(n: int, iters: int, rng, device="cuda") -> dict:
    device = torch.device(device)
    cols, run = prepare_mixed(n, rng, device)
    t = _median_time(run, iters, [device])
    decoded = sum(c.nbytes_decoded for c in cols) / 1e9
    comp = sum(c.nbytes_compressed for c in cols) / 1e9
    return {
        "decode_GBps": decoded / t,
        "ratio": decoded / comp,
        "hbm_touched_GBps": (decoded + comp) / t,
        "time_s": t,
        "vs_ref": decoded / t / 50.0,
    }


def prepare_narrow(n: int, rng, device="cuda"):
    """Storage-width decode: an int8 (as uint8) and an int16 column whose
    decoders store their own width (api.narrow_store_dtype)."""
    cols = [
        api.encode(gen_column("nbit", n, rng).astype(np.uint8), "nbit", name="narrow_u8"),
        api.encode((np.arange(n) % 20000).astype(np.int16), "delta", name="narrow_i16"),
    ]
    return _prepare_set(cols, [api.narrow_store_dtype(c) for c in cols], torch.device(device))


def bench_narrow(n: int, iters: int, rng, device="cuda") -> dict:
    """Storage-width decode: decoded GB/s is measured against the *logical*
    byte count (n * itemsize), so the 4x/2x write-traffic saving shows up
    as a correspondingly lower HBM-touched figure, not inflated GB/s."""
    device = torch.device(device)
    cols, run = prepare_narrow(n, rng, device)
    t = _median_time(run, iters, [device])
    decoded = sum(c.nbytes_decoded for c in cols) / 1e9
    comp = sum(c.nbytes_compressed for c in cols) / 1e9
    return {
        "device_kind": _device_kind(device),
        "decode_GBps": decoded / t,
        "ratio": decoded / comp,
        "hbm_touched_GBps": (decoded + comp) / t,
        "time_s": t,
        "stores": ["uint8", "uint16"],
    }


def bench_mesh(device: torch.device, shards: int | None = None) -> dist.Mesh:
    """``shards`` shards of one device, else every visible card (one CPU
    device on the CPU)."""
    if shards:
        return dist.Mesh([device] * shards)
    return dist.default_mesh() if device.type == "cuda" else dist.Mesh([device])


def bench_dist(n: int, iters: int, rng, device="cuda", shards: int | None = None) -> dict:
    """Sharded decode of a mixed scheme set over bench_mesh(device, shards).

    ``n`` is per-shard work (weak scaling): decode is collective-free data
    parallelism, so the honest efficiency statement is GB/s per shard at
    constant shard size. Efficiency vs 1 shard uses the linear formula
    GBps_nd / (nd * GBps_1) (--dist-sweep)."""
    device = torch.device(device)
    mesh = bench_mesh(device, shards)
    n_total = n * mesh.size
    cols = [
        api.encode(gen_column(s, n_total // 4, rng), s, name=f"dist_{s}")
        for s in ("nbit", "delta", "dict", "rle")
    ]
    built = [dist.build_sharded_decoder(c, mesh) for c in cols]
    devices = list(mesh.devices.flat)

    def run():
        return [f(*a) for f, a in built]

    run()
    _sync(devices)
    t = _median_time(run, iters, devices)
    decoded = sum(c.nbytes_decoded for c in cols) / 1e9
    return {
        "devices": mesh.size,
        "backend": device.type,
        "decode_GBps": decoded / t,
        "time_s": t,
    }


def _dist_sweep(args, outdir: pathlib.Path) -> dict:
    """Weak-scaling table over ``Mesh([device] * nd)`` for nd in SWEEP (a
    fresh process a point), plus the default mesh at the same per-shard
    size."""
    a1 = copy.copy(args)
    a1.n = args.dist_n
    sweep: dict[str, dict] = {}
    for nd in SWEEP:
        r = _spawn_trials("dist", a1, 1, ["--shards", str(nd)])[0]
        if r["devices"] != nd:
            raise RuntimeError(f"dist sweep nd={nd} ran on {r['devices']} shards")
        sweep[str(nd)] = r
        print(f"[bench] dist {nd} shard(s) of one {r['backend']} device: {r['decode_GBps']:8.3f} GB/s",
              file=sys.stderr)
    base = sweep["1"]["decode_GBps"]
    eff = {k: round(v["decode_GBps"] / (int(k) * base), 3) for k, v in sweep.items()}
    where = "card: they share its SMs and its one PCIe link" if torch.device(args.device).type == "cuda" \
        else "CPU device: they share the host's cores"
    result = {
        "n_per_shard": 1 << args.dist_n,
        "scaling": "weak (fixed work per shard; eff = GBps_nd / (nd * GBps_1))",
        "mesh_sweep": sweep,
        "mesh_efficiency": eff,
        "host_cores": os.cpu_count(),
        "note": f"Each point runs the real sharded decode (dist.build_sharded_decoder) as nd shards of one "
                f"{where}. So efficiency measures the sharded path's overhead (a placement and a decoder call a "
                f"shard), not scaling over cards; the decode is collective-free. Several cards or hosts: "
                f"scripts/multihost_bench_torch.py.",
    }
    # the default mesh runs at the SAME per-shard size as the sweep points,
    # so the persisted table is one consistent weak-scaling series
    result["default_mesh"] = _spawn_one("dist", a1)
    print(f"[bench] dist efficiency vs 1 shard: {eff}", file=sys.stderr)
    (outdir / "dist_sweep.json").write_text(json.dumps(result, indent=2))
    return result


def _run_one(kind: str, n: int, iters: int, device, shards: int | None = None) -> dict:
    """Executed in a fresh subprocess (--one): each measurement gets a
    clean process, and its own rng, as bench.py's do."""
    rng = np.random.default_rng(0)
    if kind == "mixed":
        return bench_mixed(n, iters, rng, device)
    if kind == "dist":
        return bench_dist(n, iters, rng, device, shards)
    if kind == "narrow":
        return bench_narrow(n, iters, rng, device)
    col, run = prepare_scheme(kind, n, rng, device)
    return time_prepared(col, run, kind, iters, device)


def _spawn_one(kind: str, args) -> dict:
    """Best-of-N fresh-process trials: the fastest trial is the closest
    to the machine's capability (standard best-of-N benchmarking)."""
    rs = _spawn_trials(kind, args, max(1, args.trials))
    return max(rs, key=lambda r: r.get("decode_GBps", 0))


def _spawn_trials(kind: str, args, trials: int, extra=()) -> list[dict]:
    """N independent fresh-process trials (no best-of reduction), each
    ``python bench_torch.py --one kind``: the single subprocess protocol
    every bench spawn goes through. The built kernel library under
    giddy_tpu_torch/_build is loaded, not rebuilt."""
    out = []
    for _ in range(trials):
        with tempfile.NamedTemporaryFile(suffix=".json") as tf:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", kind, "--n", str(args.n),
                   "--iters", str(args.iters), "--device", args.device, "--out", tf.name, *extra]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"bench subprocess {kind} failed:\n{proc.stderr[-2000:]}")
            out.append(json.loads(pathlib.Path(tf.name).read_text()))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="bench_torch.py")
    ap.add_argument("--n", type=int, default=26, help="log2 of element count per column")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--trials", type=int, default=2,
                    help="fresh-process trials per scheme; best kept")
    ap.add_argument("--schemes", type=str, default=",".join(HEADLINE))
    ap.add_argument("--mixed", action="store_true", help="also run the mixed-container config")
    ap.add_argument("--dist", action="store_true", help="also run sharded decode over local devices")
    ap.add_argument("--dist-sweep", action="store_true",
                    help="weak-scaling table over 1/2/4/8 shards of one device")
    ap.add_argument("--dist-n", type=int, default=20,
                    help="log2 elements PER SHARD for dist/sweep (weak scaling)")
    ap.add_argument("--device", default="cuda", help="device to decode on (cuda or cpu)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)  # internal
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)  # internal
    ap.add_argument("--shards", type=int, default=None, help=argparse.SUPPRESS)  # internal: --dist-sweep's point
    ap.add_argument("--no-subproc", action="store_true", help="measure in-process (debug)")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip the device-vs-oracle selftest pass")
    ap.add_argument("--no-narrow", action="store_true",
                    help="skip the storage-width (int8/int16) decode measurement")
    argv = sys.argv[1:] if argv is None else list(argv)
    for option in (a.split("=")[0] for a in argv):
        if option in NOT_PORTED:
            ap.error(f"{option} is not ported: {NOT_PORTED[option]}")
    args = ap.parse_args(argv)
    n = 1 << args.n
    device = torch.device(args.device)
    if args.one:
        r = _run_one(args.one, n, args.iters, device, args.shards)
        pathlib.Path(args.out).write_text(json.dumps(r))
        return
    schemes = ALL if args.schemes == "all" else args.schemes.split(",")
    detail = {"device": str(device) if args.no_subproc else "subproc", "n": n, "schemes": {}}
    rng = np.random.default_rng(0)
    for scheme in schemes:
        if args.no_subproc:
            col, run = prepare_scheme(scheme, n, rng, device)
            r = time_prepared(col, run, scheme, args.iters, device)
        else:
            r = _spawn_one(scheme, args)
        detail["schemes"][scheme] = r
        print(f"[bench] {scheme:8s} {r['decode_GBps']:9.2f} GB/s decoded  "
              f"(ratio {r['ratio']:6.2f}x, HBM {r['hbm_touched_GBps']:8.2f} GB/s, "
              f"{r['time_s'] * 1e3:.3f} ms)", file=sys.stderr)
    if args.mixed:
        r = bench_mixed(n, args.iters, rng, device) if args.no_subproc else _spawn_one("mixed", args)
        detail["mixed"] = r
        print(f"[bench] {'mixed':8s} {r['decode_GBps']:9.2f} GB/s decoded  "
              f"(ratio {r['ratio']:6.2f}x, {r['time_s'] * 1e3:.3f} ms)", file=sys.stderr)
    if not args.no_narrow:
        r = bench_narrow(n, args.iters, rng, device) if args.no_subproc else _spawn_one("narrow", args)
        detail["narrow"] = r
        print(f"[bench] {'narrow':8s} {r['decode_GBps']:9.2f} GB/s decoded  "
              f"(storage-width stores, ratio {r['ratio']:6.2f}x, "
              f"{r['time_s'] * 1e3:.3f} ms)", file=sys.stderr)
    outdir = RESULTS
    outdir.mkdir(parents=True, exist_ok=True)
    if args.dist:
        r = bench_dist(n, args.iters, rng, device) if args.no_subproc else _spawn_one("dist", args)
        detail["dist"] = r
        print(f"[bench] {'dist':8s} {r['decode_GBps']:9.2f} GB/s decoded on "
              f"{r['devices']} device(s)", file=sys.stderr)
    if args.dist_sweep:
        detail["dist_sweep"] = _dist_sweep(args, outdir)
    head = [s for s in HEADLINE if s in detail["schemes"]] or list(detail["schemes"])
    gbps = [detail["schemes"][s]["decode_GBps"] for s in head]
    ratios = [detail["schemes"][s]["vs_ref"] for s in head]
    geo = math.exp(sum(math.log(g) for g in gbps) / len(gbps))
    geo_ratio = math.exp(sum(math.log(r) for r in ratios) / len(ratios))
    # Honesty flag: implied memory traffic above the card's published rate
    # means the timings are not physical. The device kind comes from the
    # measurements; a device with no known rate (the CPU) gives null.
    kind = next((r["device_kind"] for r in detail["schemes"].values() if r.get("device_kind")), None)
    try:
        bw = roofline.chip_bw(kind) / 1e9 if kind else None
    except ValueError:
        bw = None
    suspect = None if bw is None else any(
        detail["schemes"][s]["hbm_touched_GBps"] > 1.1 * bw for s in detail["schemes"]
    )
    detail["timing_suspect"] = suspect
    if suspect:
        print(
            f"[bench] WARNING: implied memory rates exceed the card's published "
            f"{bw:.0f} GB/s — timings are not physical; treat GB/s as relative only",
            file=sys.stderr,
        )
    _regression_floor(detail, outdir)
    try:
        detail["ops_roofline"] = _ops_table(outdir, device)
    except Exception as e:  # census must never sink the bench line
        detail["ops_roofline_error"] = f"{type(e).__name__}: {e}"
    (outdir / "bench_detail.json").write_text(json.dumps(detail, indent=2))
    if not args.no_selftest:
        detail["selftest_pass"] = _run_selftest(outdir, device)
        (outdir / "bench_detail.json").write_text(json.dumps(detail, indent=2))
    line = {
        "metric": "decode_GBps_geomean_headline5",
        "value": round(geo, 2),
        "unit": "GB/s",
        "timing_suspect": suspect,
    }
    if suspect:
        # a ratio against 2017 GPU recollections on a non-physical clock is
        # meaningless — report it null
        line["vs_baseline"] = None
    else:
        line["vs_baseline"] = round(geo_ratio, 3)
    if "selftest_pass" in detail:
        line["selftest_pass"] = detail["selftest_pass"]
    print(json.dumps(line))


def _ops_table(outdir: pathlib.Path, device) -> dict:
    """Per-scheme compute census (roofline.ops_audit: the SASS census of
    the kernel each decode dispatches, by pipe, against the budget memory
    leaves it), into results/torch/ops_roofline.json. On the CPU the plain
    versions run: each row is ``interpreted`` with null counts."""
    device = torch.device(device)
    pipes = [p for p in roofline.PER_SM_CLOCK if p != "issue"]
    rng = np.random.default_rng(11)
    table = {}
    for scheme in ALL:
        col = api.encode(gen_column(scheme, 8 * GROUP, rng), scheme, name=f"ops_{scheme}")
        a = roofline.ops_audit(col, device)
        budget = a["budget"]
        table[scheme] = {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in a.items()
            if k != "budget"
        }
        table[scheme].update({f"budget_{p}": round(budget[f"{p}_per_elem"], 2) if budget else None
                              for p in roofline.PER_SM_CLOCK})
        if a["interpreted"]:
            print(f"[bench] ops {scheme:9s} interpreted on {device}: plain versions, no SASS census",
                  file=sys.stderr)
            continue
        busiest = max(pipes, key=lambda p: a[f"{p}_per_elem"] / budget[f"{p}_per_elem"])
        print(f"[bench] ops {scheme:9s} issue {a['issue_per_elem']:7.2f}/elem "
              f"(budget {budget['issue_per_elem']:6.1f}) "
              f"busiest {busiest} {a[f'{busiest}_per_elem']:6.2f} (budget {budget[f'{busiest}_per_elem']:6.1f}) "
              f"{'memory-bound' if a['memory_bound'] else 'OVER'}", file=sys.stderr)
    (outdir / "ops_roofline.json").write_text(json.dumps(table, indent=2))
    return table


def _run_selftest(outdir: pathlib.Path, device) -> bool:
    """Device-vs-oracle + traffic-audit selftest in a fresh process
    (giddy_tpu_torch/selftest.py). Never fails the bench; the verdict lands
    in the JSON."""
    proc = subprocess.run(
        [sys.executable, "-m", "giddy_tpu_torch.selftest", "--device", str(device),
         "--out", str(outdir / "selftest.json")],
        capture_output=True, text=True, timeout=3600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    ok = proc.returncode == 0
    print(f"[bench] selftest {'PASS' if ok else 'FAIL'}", file=sys.stderr)
    if not ok:
        print(proc.stderr[-2000:], file=sys.stderr)
    return ok


def _regression_floor(detail: dict, outdir: pathlib.Path) -> None:
    """Warn-level perf floor: compare each scheme's *relative* throughput
    (share of the run's geomean, so the absolute clock cancels) against
    the last recorded run and warn on >25% drops; then persist this run as
    the new reference."""
    ref_path = outdir / "bench_floor.json"
    gbps = {s: r["decode_GBps"] for s, r in detail["schemes"].items() if r.get("decode_GBps")}
    if len(gbps) < 3:
        # a 1-2 scheme debug run has a degenerate geomean (relative shares
        # ~1.0) — comparing or persisting it would poison the floor
        return
    geo = math.exp(sum(math.log(g) for g in gbps.values()) / len(gbps))
    rel = {s: g / geo for s, g in gbps.items()}
    prev = {}
    if ref_path.exists():
        try:
            prev = json.loads(ref_path.read_text())
        except ValueError:
            prev = {}
        drops = {
            s: round(rel[s] / prev[s], 3)
            for s in rel
            if s in prev and rel[s] < 0.75 * prev[s]
        }
        detail["floor_drops"] = drops
        for s, f in drops.items():
            print(f"[bench] WARNING: {s} relative throughput at {f:.2f}x of the "
                  f"last recorded run (floor is 0.75x) — investigate before "
                  f"trusting this build's perf", file=sys.stderr)
    # merge: a HEADLINE-only run must not truncate the all-schemes record
    ref_path.write_text(json.dumps({**prev, **rel}, indent=2))


if __name__ == "__main__":
    main()
