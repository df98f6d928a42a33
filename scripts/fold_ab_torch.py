#!/usr/bin/env python3
"""K16 (filter_fold) and K17 (agg_fold) of giddy_tpu_torch timed side by
side for two checkouts on one NVIDIA GPU, with K1 (lmp_unpack) as the
control that neither changes; and K7 (delta2_decode), with K3
(delta_decode) as its control.

    python3 scripts/fold_ab_torch.py PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 scripts/fold_ab_torch.py --k7 ROOT [ROOT ...]
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

    def timed(label: str, fn, plain) -> None:
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
    flag = "--one"
    if argv[:1] == ["--k7"]:
        flag, argv = "--one-k7", argv[1:]
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
        print(f"[ab] {label}: bound {runs[0][1][label]['bound_ms']:.4f} ms | {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
