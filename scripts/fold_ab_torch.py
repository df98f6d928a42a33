#!/usr/bin/env python3
"""K16 (filter_fold) and K17 (agg_fold) of giddy_tpu_torch timed side by
side for two checkouts on one NVIDIA GPU, with K1 (lmp_unpack) as the
control that neither changes; K7 (delta2_decode), with K3
(delta_decode) as its control; and K5 (run_expand) at the reference's
_rank_call cell, with its chain-form cells as controls.

    python3 scripts/fold_ab_torch.py PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 scripts/fold_ab_torch.py --k7 ROOT [ROOT ...]
    python3 scripts/fold_ab_torch.py --k5 ROOT [ROOT ...]
    python3 scripts/fold_ab_torch.py --ptxas [ROOT [SASS_FILE]]
    python3 scripts/fold_ab_torch.py --ncu ROOT [ROOT ...]

Each ROOT is the root of a checkout (say a ``git archive`` of the parent
commit unpacked under the git-ignored ``_scratch/``). For each, in the
order given, a fresh process imports that checkout's giddy_tpu_torch,
builds its kernels into its own ``_build/`` and times, on resident streams
(CUDA events, median of 20 after warm-up, the runs queued behind a sleep
kernel so that the host's launch time adds no gap; beside it the host's
time to launch one call), each kernel at chip_smoke.py's
cells: configs[0] (nbit 9 bits, 2^28: K16 ``lt 256``, K17 sum and min, K1),
the configs[1] timestamps as FOR (16 bits with frame refs, 2^26: K16 ``lt``
the middle value, K17 sum) and their 1%-null twin (validity words: K16 and
K17 sum), and the configs[1] timestamps as delta2 (K7, 3 bits) and as delta
(K3, the control). Every output is first held against the checkout's plain
version. One line a run: ``[ab] ROOT {json}``, then a table of the medians
per root. The bound is the call's bytes (each input read once, each output
written once) over 3.35 TB/s, which bounds every one of these calls.
``--k7`` times the K7 cell and its K3 control alone.

``--k5`` times K5 at chip_smoke.py's K5 cells: the _rank_call cell (rle,
runs of 1-39 over 1000 values, 2^26, seed 7: T = 32 tiles of w_pad 128),
configs[3] as rle and rpe and the cascade rle d=8 column (the chain form,
w_pad <= 16: the controls), and three made-up tables of 2048 groups that
pull K5's costs apart: one tile of 128 runs (a small table, the deep
search), 32 tiles of one run padded to 128 (a large table, a short
search) and 32 tiles of 8 runs (the chain form's small tables). The
cells' bound counts the real runs' 8 bytes (chip_smoke.py's run_bytes);
the made-up tables' counts their tables; beside it, the bytes of the
tables (each read once) and of what run_strip_kernel's warps load of them
(strip_loads), each with the output. Before timing, it prints each of
the root's K5 kernels' resident blocks an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor, from a small library that
includes the root's csrc/run_decode.cu).

``--ptxas`` compiles csrc/scan_epilogue.cu, csrc/run_decode.cu and
csrc/lmp_decode.cu of ROOT (this checkout by default) with this checkout's
nvcc flags and ``-Xptxas -v`` and prints each kernel's registers, spills
and shared memory; given SASS_FILE, it writes the kernels' SASS there
(``cuobjdump -sass``) and prints each kernel's static instruction count,
its loads and the sizes of its loops.

``--ncu`` profiles, for each ROOT, the first K16 and the first K17 launch
(configs[0]: K16 ``lt 256``, K17 sum) with Nsight Compute (``ncu --set
full``) and prints its duration, DRAM throughput, registers a thread,
shared memory a block, achieved occupancy and the three largest warp stall
reasons (cycles a warp stalls for that reason per issued instruction).

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(torch, fn, runs: int = 20) -> float:
    """Median CUDA-event time of fn() after warm-up. A sleep kernel of ~10
    ms goes first, so every run is queued before the card reaches it and
    the host's time to launch a call, which can exceed a kernel of 0.1 ms,
    adds no gap between the events."""
    for _ in range(3):
        fn()
    torch.cuda._sleep(20_000_000)
    pairs = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def timed_cell(torch, cells: dict, label: str, fn, plain) -> None:
    """Hold fn() against plain() (equal), then time it: cells[label] gets
    its median ms, the host's us a launch and its output bytes."""
    out = fn()
    want = plain()
    torch.cuda.synchronize()
    outs, wants = (out, want) if isinstance(out, tuple) else ((out,), (want,))
    assert all(torch.equal(o, w) for o, w in zip(outs, wants)), f"{label}: kernel != plain version"
    nbytes = sum(t.numel() * t.element_size() for t in outs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    cells[label] = {"ms": cuda_ms(torch, fn), "host_us": host_us, "out_bytes": nbytes}
    del out, want


def one(root: str, k7_only: bool = False) -> None:
    """Time every cell (or the K7 cell and its control) with the
    giddy_tpu_torch under ``root``; print one line."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import kernels, nulls, query
    from giddy_tpu_torch.kernels import _build, agg, filter_, lanes, nbit

    assert pathlib.Path(gtt.__file__).resolve().is_relative_to(pathlib.Path(root).resolve()), gtt.__file__
    cuda = torch.device("cuda")
    _build.lib()
    print(f"[build] {root}: nvcc {_build.build_seconds} s", flush=True)
    v0 = np.random.default_rng(0).integers(0, 512, 2**28, dtype=np.int64).astype(np.int32)
    ts = (np.cumsum(np.random.default_rng(1).integers(0, 4, 2**26)) + 1_700_000_000).astype(np.int32)
    valid = np.random.default_rng(8).random(ts.shape[0]) >= 0.01
    cells = {}
    timed = functools.partial(timed_cell, torch, cells)

    for cell, v, scheme, opts, mask in [] if k7_only else [
        ("configs[0] nbit 9-bit 2^28", v0, "nbit", {"bits": 9}, None),
        ("configs[1] for 2^26", ts, "for", {}, None),
        ("configs[1] for 1% nulls 2^26", ts, "for", {}, valid),
    ]:
        col = gtt.encode(v, scheme, valid=mask, **opts)
        streams = gtt.device_streams(col, cuda)
        packed, refs = streams["packed"], streams.get("refs_g")
        vw = nulls.valid_words_device(col, cuda) if mask is not None else None
        bits, kind, size = col.params["bits"], v.dtype.kind, v.dtype.itemsize
        in_bytes = sum(t.numel() * t.element_size() for t in (packed, refs, vw) if t is not None)
        value = 256 if scheme == "nbit" else int(v[v.shape[0] // 2])
        key = query._stage_key(col.dtype, value)
        args = (packed, refs, vw, bits, kind, size, "lt", key)
        timed(f"{cell} K16 lt {value}", lambda: filter_.filter_fold(*args), lambda: lanes.filter_fold(*args))
        for name in ("sum", "min") if scheme == "nbit" else ("sum",):
            a = (packed, refs, vw if name == "sum" else None, bits, col.n, kind, size, name)
            timed(f"{cell} K17 {name}", lambda: agg.agg_fold(*a), lambda: lanes.agg_fold(*a))
        if scheme == "nbit":
            timed(f"{cell} K1 control", lambda: nbit.lmp_unpack(packed, bits), lambda: lanes.lmp_unpack(packed, bits))
        for label, c in cells.items():
            if label.startswith(cell) and "bound_ms" not in c:
                c["bound_ms"] = (in_bytes + c.pop("out_bytes")) / HBM_BYTES_PER_S * 1e3
        del streams, packed, refs, vw
        torch.cuda.empty_cache()
    for label, scheme in (("configs[1] delta2 2^26 K7", "delta2"), ("configs[1] delta 2^26 K3 control", "delta")):
        col = gtt.encode(ts, scheme)
        name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
        wrapper = getattr(kernels.WRAPPERS[name], name)
        timed(label, lambda: wrapper(*args), lambda: getattr(lanes, name)(*args))
        in_bytes = sum(t.numel() * t.element_size() for t in args if isinstance(t, torch.Tensor))
        cells[label]["bound_ms"] = (in_bytes + cells[label].pop("out_bytes")) / HBM_BYTES_PER_S * 1e3
        del args
        torch.cuda.empty_cache()
    print(f"[ab] {root} {json.dumps(cells)}", flush=True)


# K5's kernels in csrc/run_decode.cu, for the occupancy report: (template,
# instance, threads a block, dynamic shared bytes, the cell it stands for).
# run_expand_kernel (K5's earlier kernel) staged T * w_pad ends and values: 32 KiB
# at the _rank_call cell's T = 32 and w_pad 128.
K5_KERNELS = [
    ("run_expand_kernel", "gt::run_expand_kernel<uint32_t, gt::LutMode::kNone>", 1024, 32768, "T 32, w_pad 128"),
    ("run_expand_kernel", "gt::run_expand_kernel<uint32_t, gt::LutMode::kNone>", 1024, 64, "T 1, w_pad 8"),
    ("run_strip_kernel", "gt::run_strip_kernel<uint32_t, gt::LutMode::kNone, 4>", "gt::kRunThreads", 0, "w_pad 128"),
    ("run_strip_kernel", "gt::run_strip_kernel<uint32_t, gt::LutMode::kGlobal, 4>", "gt::kRunThreads", 0,
     "w_pad 128, a table"),
    ("run_strip_kernel", "gt::run_strip_kernel<uint32_t, gt::LutMode::kNone, 1>", "gt::kRunThreads", 0,
     "w_pad <= 32"),
]


def k5_occupancy(root: str) -> None:
    """Registers, static shared bytes and resident blocks an SM of each K5
    kernel that ROOT's csrc/run_decode.cu defines, from a small library
    built with this checkout's nvcc flags that includes that source."""
    import ctypes
    import tempfile

    sys.path.insert(0, str(HERE))
    from giddy_tpu_torch.kernels import _build

    src = pathlib.Path(root).resolve() / "giddy_tpu_torch" / "csrc" / "run_decode.cu"
    text = src.read_text()
    rows = [k for k in K5_KERNELS if f"{k[0]}(" in text]
    cases = "".join(
        f"    case {i}: {{ auto k = {inst}; cudaFuncGetAttributes(&a, k); out[1] = a.numRegs; "
        f"out[2] = static_cast<int>(a.sharedSizeBytes); out[3] = {threads}; "
        f"return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, {threads}, {smem}); }}\n"
        for i, (_, inst, threads, smem, _) in enumerate(rows))
    probe = (f'#include "{src}"\nextern "C" int gt_k5_occupancy(int which, int* out) {{\n'
             f"  cudaFuncAttributes a;\n  switch (which) {{\n{cases}  }}\n  return -1;\n}}\n")
    with tempfile.TemporaryDirectory() as tmp:
        (pathlib.Path(tmp) / "probe.cu").write_text(probe)
        lib = f"{tmp}/probe.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, f"{tmp}/probe.cu"], check=True,
                       timeout=600)
        probe_lib = ctypes.CDLL(lib)
        for i, (_, inst, _, smem, cell) in enumerate(rows):
            out = (ctypes.c_int * 4)()
            rc = probe_lib.gt_k5_occupancy(i, out)
            print(f"[occupancy] {root} {inst} ({cell}): {out[1]} registers a thread, {out[2]} B static + {smem} B "
                  f"dynamic shared, {out[3]} threads a block: {out[0]} blocks an SM (rc {rc})", flush=True)


def run_column(np, rng, n: int, lo: int, hi: int, vocab: int) -> object:
    """chip_smoke.py's run_column: n int32 values in runs of lo..hi-1, each
    run one of ``vocab`` random values."""
    lengths = rng.integers(lo, hi, n // lo + 1)
    pool = rng.integers(0, 2**32, vocab, dtype=np.uint64).astype(np.uint32).astype(np.int32)
    return np.repeat(pool[rng.integers(0, vocab, lengths.shape[0])], lengths)[:n]


def config3_flags(np) -> object:
    """chip_smoke.py's configs[3]: flags 0-4 in runs of 100-5000, 2^26, seed 3."""
    n = 1 << 26
    rng = np.random.default_rng(3)
    v = np.zeros(n, dtype=np.int32)
    pos = 0
    while pos < n:
        ln = int(rng.integers(100, 5000))
        v[pos : pos + ln] = int(rng.integers(0, 5))
        pos += ln
    return v


def strip_loads(np, ends, width: int) -> int:
    """Bytes run_strip_kernel's warps load from (rows, w_pad) tables of
    tiles of ``width``: for each span of min(width, 1024) positions, all
    w_pad ends, and the values of the lanes (E = max(1, w_pad / 32)
    entries each) that hold a run the span selects, from the first run
    ending at or past the span's start to the first ending at or past its
    end."""
    rows, w_pad = ends.shape
    per_lane = max(1, w_pad // 32)
    span = min(width, 1024)
    counted = np.arange(w_pad) < w_pad - 1
    total = 0
    for start in range(0, width, span):
        carry = ((ends < start) & counted).sum(axis=1)
        last = ((ends < start + span) & counted).sum(axis=1)
        total += rows * w_pad * 4 + int((last // per_lane - carry // per_lane + 1).sum()) * per_lane * 4
    return total


def one_k5(root: str) -> None:
    """K5 at its cells with the giddy_tpu_torch under ``root``; one line."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import kernels
    from giddy_tpu_torch.datagen import gen_column
    from giddy_tpu_torch.kernels import _build, lanes, rle
    from giddy_tpu_torch.util import GROUP

    assert pathlib.Path(gtt.__file__).resolve().is_relative_to(pathlib.Path(root).resolve()), gtt.__file__
    cuda = torch.device("cuda")
    _build.lib()
    print(f"[build] {root}: nvcc {_build.build_seconds} s", flush=True)
    k5_occupancy(root)
    cells = {}
    timed = functools.partial(timed_cell, torch, cells)
    columns = [
        ("rank cell rle runs ~20 2^26", run_column(np, np.random.default_rng(7), 2**26, 1, 40, 1000), "rle"),
        ("configs[3] rle 2^26", config3_flags(np), "rle"),
        ("configs[3] rpe 2^26", config3_flags(np), "rpe"),
        ("cascade rle d=8 2^26", gen_column("cascade", 2**26, np.random.default_rng(6)), "cascade"),
    ]
    for label, v, scheme in columns:
        col = gtt.encode(v, scheme)
        name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
        assert name == "run_expand", f"{label}: {name}"
        tables = sum(t.numel() * t.element_size() for t in args if isinstance(t, torch.Tensor))
        label = f"{label} T {args[0].shape[0] // args[2]} w_pad {args[0].shape[1]}"
        timed(label, lambda: rle.run_expand(*args), lambda: lanes.run_expand(*args))
        runs = int(col.streams["c_run_counts" if scheme == "cascade" else "run_counts"].sum())
        in_bytes = runs * 8 + (col.streams["values"].nbytes if scheme == "cascade" else 0)
        out_bytes = cells[label].pop("out_bytes")
        cells[label]["bound_ms"] = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        cells[label]["tables_ms"] = (tables + out_bytes) / HBM_BYTES_PER_S * 1e3
        loads = strip_loads(np, args[0].cpu().numpy(), GROUP * args[2] // args[0].shape[0])
        cells[label]["loads_ms"] = (loads + out_bytes) / HBM_BYTES_PER_S * 1e3
        del args
        torch.cuda.empty_cache()
    ng = 2048
    vals = torch.from_numpy(np.random.default_rng(9).integers(0, 2**32, (ng * 32, 128), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(cuda)
    for label, tiles, w_pad, runs in [("made-up T 1 w_pad 128, 128 runs a tile", 1, 128, 128),
                                      ("made-up T 32 w_pad 128, 1 run a tile", 32, 128, 1),
                                      ("made-up T 32 w_pad 8, 8 runs a tile", 32, 8, 8)]:
        width = GROUP // tiles
        m = torch.arange(w_pad, dtype=torch.int32, device=cuda)
        row = torch.where(m < runs - 1, (m + 1) * (width // runs), width)
        ends = row.expand(ng * tiles, w_pad).contiguous()
        v = vals[: ng * tiles, :w_pad].contiguous()
        timed(label, lambda: rle.run_expand(ends, v, ng), lambda: lanes.run_expand(ends, v, ng))
        cells[label]["bound_ms"] = (2 * ends.numel() * 4 + cells[label].pop("out_bytes")) / HBM_BYTES_PER_S * 1e3
        del ends, v
    print(f"[ab] {root} {json.dumps(cells)}", flush=True)


def sass_census(sass: str, only: str = "") -> None:
    """Static SASS instructions of each kernel (whose name holds ``only``),
    with its loads from device and shared memory and its loops (a branch
    back to an earlier address: the instructions from its target to it)."""
    import re

    name, counts = None, {}
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1) if only in head.group(1) else None
            if name:
                counts[name] = {"all": 0, "LDG": 0, "LDS": 0, "loops": []}
            continue
        op = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)(?:\.\S+)?\s*(0x[0-9a-f]+)?", line)
        if name and op:
            c = counts[name]
            c["all"] += 1
            kind = op.group(2)
            c["LDG"] += kind == "LDG"
            c["LDS"] += kind == "LDS"
            at = int(op.group(1), 16)
            if kind == "BRA" and op.group(3) and int(op.group(3), 16) < at:
                c["loops"].append((at - int(op.group(3), 16)) // 16 + 1)
    for name, c in counts.items():
        loops = f", loops of {c['loops']} instructions" if c["loops"] else ""
        print(f"[sass] {name}: {c['all']} instructions, {c['LDG']} LDG, {c['LDS']} LDS{loops}")


def ptxas(root: str, sass: str | None, sources: tuple = ("scan_epilogue.cu", "run_decode.cu", "lmp_decode.cu"),
          only: str = "") -> None:
    """nvcc of each csrc/<source> of ROOT with this checkout's flags and
    -Xptxas -v (registers, spills, shared memory a kernel); with ``sass``,
    their SASS written there and its census (kernels whose name holds
    ``only``)."""
    import tempfile

    sys.path.insert(0, str(HERE))
    from giddy_tpu_torch.kernels import _build

    dumps = []
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            src = pathlib.Path(root) / "giddy_tpu_torch" / "csrc" / source
            obj = f"{tmp}/{src.stem}.o"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, str(src)]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            print(out.stderr)
            print(f"[ptxas] nvcc of {src.name}: {time.perf_counter() - t0:.1f} s")
            if out.returncode:
                sys.exit(out.returncode)
            if sass:
                tool = str(pathlib.Path(_build._nvcc()).parent / "cuobjdump")
                dumps.append(subprocess.run([tool, "-sass", obj], capture_output=True, text=True, timeout=600,
                                            check=True).stdout)
    if sass:
        pathlib.Path(sass).write_text("".join(dumps))
        sass_census("".join(dumps), only)


NCU_METRICS = {
    "gpu__time_duration.sum": "duration",
    "dram__throughput.avg.pct_of_peak_sustained_elapsed": "DRAM throughput % of peak",
    "dram__bytes_read.sum.per_second": "DRAM read rate",
    "launch__registers_per_thread": "registers a thread",
    "launch__shared_mem_per_block_dynamic": "dynamic shared memory a block",
    "launch__shared_mem_per_block_static": "static shared memory a block",
    "sm__warps_active.avg.pct_of_peak_sustained_active": "achieved occupancy %",
}
STALL = "smsp__average_warps_issue_stalled_"


def ncu(roots: list[str]) -> int:
    """Nsight Compute's reading of one K16 and one K17 launch per root."""
    import csv
    import io
    import shutil

    tool = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    for root in roots:
        for kernel in ("filter_fold_kernel", "agg_fold_kernel"):
            cmd = [tool, "--set", "full", "-k", f"regex:{kernel}", "-c", "1", "--csv", "--page", "raw",
                   sys.executable, __file__, "--one", root]
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            lines = [x for x in out.stdout.splitlines() if x.startswith('"')]
            if out.returncode or len(lines) < 3:
                print(f"[ncu] {root} {kernel}: ncu rc {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
                return out.returncode or 1
            head, units, values = (next(csv.reader(io.StringIO(x))) for x in lines[:3])
            got = {h: (v, u) for h, u, v in zip(head, units, values)}
            fields = [f"{label} {got[m][0]} {got[m][1]}".rstrip() for m, label in NCU_METRICS.items() if m in got]
            stalls = sorted(((float(v[0].replace(",", "")), h[len(STALL):].split("_per_")[0])
                             for h, v in got.items() if h.startswith(STALL) and h.endswith("_per_issue_active.ratio")),
                            reverse=True)
            print(f"[ncu] {root} {kernel}: {'; '.join(fields)}; top stalls "
                  f"{', '.join(f'{name} {value:.2f}' for value, name in stalls[:3])}", flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--ptxas"]:
        ptxas(argv[1] if len(argv) > 1 else str(HERE), argv[2] if len(argv) > 2 else None)
        return 0
    if argv[:1] == ["--ncu"]:
        return ncu(argv[1:])
    if argv[:1] in (["--one"], ["--one-k7"]):
        one(argv[1], argv[0] == "--one-k7")
        return 0
    if argv[:1] == ["--one-k5"]:
        one_k5(argv[1])
        return 0
    flag = "--one"
    if argv[:1] in (["--k7"], ["--k5"]):
        flag, argv = f"--one-{argv[0][2:]}", argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        out = subprocess.run([sys.executable, __file__, flag, root], capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        line = next(x for x in out.stdout.splitlines() if x.startswith("[ab] "))
        runs.append((root, json.loads(line.split(" ", 2)[2])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[ab] {smi}; ms, CUDA events, median of 20 queued runs; kernel/bound, host us a call to launch")
    for label in runs[0][1]:
        row = "  ".join(f"{c[label]['ms']:.4f} ({c[label]['bound_ms'] / c[label]['ms']:.3f}, {c[label]['host_us']:.0f} us)"
                        for _, c in runs)
        ceiling = runs[0][1][label].get("tables_ms")
        loads = runs[0][1][label].get("loads_ms")
        tables = f" (tables {ceiling:.4f}, run_strip_kernel's loads {loads:.4f})" if ceiling else ""
        print(f"[ab] {label}: bound {runs[0][1][label]['bound_ms']:.4f} ms{tables} | {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
