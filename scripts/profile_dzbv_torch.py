#!/usr/bin/env python3
"""Where a dzbv decode's time goes on an NVIDIA GPU, for giddy_tpu_torch.

    python3 scripts/profile_dzbv_torch.py
    python3 scripts/profile_dzbv_torch.py --ab ROOT [ROOT ...]
    python3 scripts/profile_dzbv_torch.py --ptxas [ROOT [SASS_FILE]]

With no arguments: for the 2^26 dzbv column of chip_smoke.py
(``gen_column("dzbv", 2**26, default_rng(13))``), in each stream form, the
host prep's time, then ten calls of the form's wrapper on resident streams
under ``torch.profiler``, whose table splits the device time by kernel (K15
runs a count kernel, a torch cumsum over the groups and its decode), and
the CUDA-event median of 20 calls. Last, the static SASS instruction count
of each dzbv kernel in the built library (``cuobjdump``, where the toolkit
has it).

``--ab`` times K13 (the tile form, forced), K14 (the group-row form), K15
(the on-disk planes) and K1 (``lmp_unpack`` of the column's plane 0, the
control) at that cell for each ROOT, the root of a checkout (say a ``git
archive`` of the parent unpacked under the git-ignored ``_scratch/``): in
the order given, a fresh process imports that checkout's giddy_tpu_torch,
builds its kernels into its own ``_build/``, holds every output against the
checkout's plain version (and the decodes against the input), then times
each call on resident streams (scripts/fold_ab_torch.py ``cuda_ms``: CUDA
events, median of 20, the runs queued behind a sleep kernel; beside it the
host's time to launch one call). K15's call is also split into its three
parts, the count kernel, the torch cumsum over the groups (with its casts)
and the decode, by the device time ``torch.profiler`` gives each kernel
over 20 queued calls. A ROOT written ``unchecked:PATH`` is timed without
the checks: a diagnostic build whose output is wrong by design. One line a
run, ``[ab] ROOT {json}``, then a table of the medians against the bound
(the compressed streams read once and the int32 output written once over
3.35 TB/s, as chip_smoke.py counts it).

``--ptxas`` compiles csrc/dzbv_decode.cu of ROOT (this checkout by default)
with ``-Xptxas -v`` (registers, spills and shared memory of each kernel);
given SASS_FILE, it writes the SASS there and prints each dzbv kernel's
census (scripts/fold_ab_torch.py ``ptxas`` and ``sass_census``).

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import fold_ab_torch  # noqa: E402  (scripts/, beside this file)

HERE = pathlib.Path(__file__).resolve().parent.parent
FORMS = ("tile", "group", "plane")


def library_sass(lib: pathlib.Path) -> str:
    """The SASS of the built library (``cuobjdump -sass``), or "" where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return ""
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout


def dzbv_column(gtt):
    """The 2^26 dzbv column of chip_smoke.py: (values, encoded column)."""
    v = gtt.datagen.gen_column("dzbv", 2**26, np.random.default_rng(13))
    return v, gtt.encode(v, "dzbv")


def profile() -> int:
    sys.path.insert(0, str(HERE))
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import kernels
    from giddy_tpu_torch.kernels import _build, dzbv

    cuda = torch.device("cuda")
    print(smi())
    _build.lib()
    v, col = dzbv_column(gtt)
    for form in FORMS:
        t0 = time.perf_counter()
        host = dzbv.form_streams(col, form)
        prep_s = time.perf_counter() - t0
        name, args = kernels.kernel_call(col, gtt.upload(host, cuda), torch.int32)
        wrapper = getattr(dzbv, name)
        check = wrapper(*args).reshape(-1)[: col.n].cpu().numpy()
        if check.tobytes() != v.tobytes():
            raise RuntimeError(f"{name} is wrong on the {form} form")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                wrapper(*args)
            torch.cuda.synchronize()
        print(f"[profile] {form} form, {name}: host prep {prep_s:.3f} s; CUDA-event median of 20 queued calls "
              f"{fold_ab_torch.cuda_ms(torch, lambda: wrapper(*args)):.4f} ms; device time of 10 calls by kernel:")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6, max_name_column_width=70))
    fold_ab_torch.sass_census(library_sass(_build.library_path()), "dzbv")
    return 0


def plane_parts(fn, runs: int = 20) -> dict:
    """ms a call of K15's count kernel, its decode and everything else (the
    torch cumsum and its casts), from the device time of each kernel under
    torch.profiler over ``runs`` calls queued behind a sleep kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    parts = {"count": 0.0, "cumsum and casts": 0.0, "decode": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if not us or "sleep" in e.key or "spin" in e.key:  # the sleep kernel (spin_kernel)
            continue
        part = "count" if "plane_counts" in e.key else "decode" if "dzbv" in e.key else "cumsum and casts"
        parts[part] += us / runs / 1e3
    return parts


def one(root: str, checked: bool) -> None:
    """Time K13, K14, K15 and K1 with the giddy_tpu_torch under ``root``;
    print one line."""
    sys.path.insert(0, root)
    import giddy_tpu_torch as gtt
    from giddy_tpu_torch import kernels
    from giddy_tpu_torch.kernels import _build, dzbv, lanes, nbit

    assert pathlib.Path(gtt.__file__).resolve().is_relative_to(pathlib.Path(root).resolve()), gtt.__file__
    cuda = torch.device("cuda")
    _build.lib()
    print(f"[build] {root}: nvcc {_build.build_seconds} s", flush=True)
    v, col = dzbv_column(gtt)
    bound_ms = (col.nbytes_compressed + col.nbytes_decoded) / fold_ab_torch.HBM_BYTES_PER_S * 1e3
    cells = {}

    def timed(label: str, fn, plain, want: np.ndarray | None, bound: float, shape=None) -> None:
        if checked:
            out, expect = fn(), plain()
            torch.cuda.synchronize()
            assert torch.equal(out, expect), f"{label}: kernel != plain version"
            assert want is None or out.reshape(-1)[: want.shape[0]].cpu().numpy().tobytes() == want.tobytes(), label
            del out, expect
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        cells[label] = {"ms": fold_ab_torch.cuda_ms(torch, fn), "host_us": host_us, "bound_ms": bound, "shape": shape}

    for form in FORMS:
        streams = gtt.upload(dzbv.form_streams(col, form), cuda)
        name, args = kernels.kernel_call(col, streams, torch.int32)
        shape = [a.shape[1] // (64 if form == "tile" else 1024) if a is not None else None for a in args[2]]
        timed(f"{name} ({form} form)", lambda: getattr(dzbv, name)(*args), lambda: getattr(lanes, name)(*args),
              v.view(np.int32), bound_ms, shape if form != "plane" else None)
        if form == "plane":
            cells[f"{name} ({form} form)"]["parts"] = plane_parts(lambda: getattr(dzbv, name)(*args))
            p0 = streams["plane0"]
            k1_bound = (p0.numel() * 4 + p0.shape[0] * 32768 * 4) / fold_ab_torch.HBM_BYTES_PER_S * 1e3
            timed("lmp_unpack (plane 0, 8 bits; control)", lambda: nbit.lmp_unpack(p0, 8),
                  lambda: lanes.lmp_unpack(p0, 8), None, k1_bound)
        del streams, args
        torch.cuda.empty_cache()
    print(f"[ab] {root} {json.dumps(cells)}", flush=True)


def ab(roots: list[str]) -> int:
    """Each root in a fresh process, in order; a root that fails is
    reported and left out of the table, and the exit code says so."""
    runs, failed = [], []
    for spec in roots:
        root, flag = (spec[len("unchecked:"):], "--ab-unchecked") if spec.startswith("unchecked:") else (spec, "--ab-one")
        out = subprocess.run([sys.executable, __file__, flag, root], capture_output=True, text=True, timeout=1200)
        sys.stdout.write(out.stdout)
        if out.returncode:
            print(f"[ab] {spec} FAILED (rc {out.returncode}):\n{out.stderr[-3000:]}", flush=True)
            failed.append(spec)
            continue
        line = next(x for x in out.stdout.splitlines() if x.startswith("[ab] "))
        runs.append((spec, json.loads(line.split(" ", 2)[2])))
    if not runs:
        return 1
    sys.path.insert(0, str(HERE))
    from giddy_tpu_torch.kernels import _wrap

    print(f"[ab] {smi()}; ms, CUDA events, median of 20 queued runs; kernel/bound, host us a call to launch")
    for label, c in runs[0][1].items():
        staged = ""
        form = next((f for f in ("tile", "group") if f"({f} form)" in label), None)
        if form:
            staged = f"; staged {_wrap.dzbv_plan(form, c['shape'])} B a group at {c['shape']}"
        row = "  ".join(f"{r[label]['ms']:.4f} ({r[label]['bound_ms'] / r[label]['ms']:.3f}, {r[label]['host_us']:.0f} us)"
                        for _, r in runs)
        print(f"[ab] {label}: bound {c['bound_ms']:.4f} ms{staged} | {row}")
        if "parts" in c:
            print(f"[ab] {label} by part, ms: " + "  ".join(
                "/".join(f"{r[label]['parts'][p]:.4f}" for p in c["parts"]) for _, r in runs) + f" ({', '.join(c['parts'])})")
    print("[ab] roots: " + "  ".join(spec for spec, _ in runs))
    return 1 if failed else 0


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main(argv: list[str]) -> int:
    if argv[:1] == ["--ptxas"]:
        fold_ab_torch.ptxas(argv[1] if len(argv) > 1 else str(HERE), argv[2] if len(argv) > 2 else None,
                            ("dzbv_decode.cu",), "dzbv")
        return 0
    if not torch.cuda.is_available():
        print("profile_dzbv_torch: torch sees no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] in (["--ab-one"], ["--ab-unchecked"]):
        one(argv[1], argv[0] == "--ab-one")
        return 0
    if argv[:1] == ["--ab"]:
        return ab(argv[1:]) if argv[1:] else 2
    return profile()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
