"""Builds and loads the CUDA kernels in ``giddy_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` file for ``sm_90a``
(one process per source, all started together) and links them into one
shared library with a plain C interface, under ``giddy_tpu_torch/_build/``
(git-ignored), named by a hash of the sources and flags, so an edited
source builds anew. The library is loaded with ctypes; every pointer and
the stream pass as ``c_void_p``. Nothing here runs at import: the CPU
tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math, -ftz or -prec-* flag: alp's decoder (K12) is
# bit-exact only with IEEE rounding and subnormals kept.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
_SIGNATURES = {
    "gt_lmp_unpack": [_P, _P, _L, _I, _I, _P, _L, _P],
    "gt_for_unpack": [_P, _P, _P, _L, _I, _I, _P, _L, _P],
    "gt_delta_decode": [_P, _P, _P, _L, _I, _I, _P, _L, _P],
    "gt_dict_decode": [_P, _P, _P, _L, _I, _L, _I, _P],
    "gt_dict_shared": [_L],
    "gt_run_expand": [_P, _P, _P, _L, _I, _I, _I, _P, _L, _P],
    "gt_cumsum_rows": [_P, _P, _L, _I, _P, _L, _P],
    "gt_delta2_decode": [_P, _P, _P, _P, _L, _I, _I, _P, _L, _P],
    "gt_delta2_shared": [_L],
    "gt_xordelta_decode": [_P, _P, _P, _L, _I, _P],
    "gt_patched_decode": [_P, _P, _P, _P, _P, _L, _I, _L, _I, _P],
    "gt_model_decode": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
    "gt_bitmap_decode": [_P, _P, _P, _L, _L, _I, _P],
    "gt_alp_decode": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _U, _L, _P],
    "gt_dzbv_tile_decode": [_P, _P, _P, _P, _P, _L, _L, _L, _P, _L, _I, _P],
    "gt_dzbv_group_decode": [_P, _P, _P, _P, _P, _L, _L, _L, _P, _L, _I, _P],
    "gt_dzbv_plane_counts": [_P, _P, _L, _P],
    "gt_dzbv_plane_decode": [_P, _P, _P, _P, _P, _L, _L, _L, _P, _P, _P, _L, _I, _P],
    "gt_filter_fold": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P],
    "gt_agg_fold": [_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _I, _I, _P],
    "gt_lmp_pack": [_P, _P, _P, _L, _I, _I, _L, _I, _P],
    "gt_run_filter": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P],
}

_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run, when one ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libgiddy_decode_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cmd in cmds]
    failed = []
    try:
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    finally:
        for proc in procs:  # after a timeout: stop the others too
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(out: pathlib.Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_suffix(f".{tag}")
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)])
        _run_all([[nvcc, "-shared", *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees the whole file or none
    build_seconds = time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source has no build."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            _compile(path)
        loaded = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = loaded
    return _LIB

