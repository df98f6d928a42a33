#!/usr/bin/env python3
"""Where a dzbv decode's time goes on an NVIDIA GPU, for giddy_tpu_torch.

For the 2^26 dzbv column of chip_smoke.py (``gen_column("dzbv", 2**26,
default_rng(13))``), in each stream form: the host prep's time, then ten
calls of the form's wrapper on resident streams under ``torch.profiler``,
whose table splits the device time by kernel (K15 runs a count kernel, a
torch cumsum over the groups and its decode), and the CUDA-event median of
20 calls. Last, the static SASS instruction count of each dzbv kernel in the
built library (``cuobjdump``, where the toolkit has it).

    python3 scripts/profile_dzbv_torch.py

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import giddy_tpu_torch as gtt  # noqa: E402
from giddy_tpu_torch import kernels  # noqa: E402
from giddy_tpu_torch.kernels import _build, dzbv  # noqa: E402


def cuda_ms(fn, runs: int = 20) -> float:
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def sass_counts(lib: pathlib.Path) -> dict[str, int]:
    """Static SASS instructions of each dzbv kernel in the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1) if "dzbv" in head.group(1) else None
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            counts[name] = counts.get(name, 0) + 1
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_dzbv_torch: torch sees no CUDA device", file=sys.stderr)
        return 2
    cuda = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    _build.lib()
    v = gtt.datagen.gen_column("dzbv", 2**26, np.random.default_rng(13))
    col = gtt.encode(v, "dzbv")
    for form in ("tile", "group", "plane"):
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
        print(f"[profile] {form} form, {name}: host prep {prep_s:.3f} s; CUDA-event median of 20 calls "
              f"{cuda_ms(lambda: wrapper(*args)):.4f} ms; device time of 10 calls by kernel:")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6, max_name_column_width=70))
    for fn, n in sorted(sass_counts(_build.library_path()).items()):
        print(f"[sass] {fn}: {n} instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
