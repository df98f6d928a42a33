"""ctypes bridge to the port's C++ host codec (csrc/host_lmp.cpp).

Counterpart of giddy_tpu/native.py. At first use the library is built with
g++ (``-O3 -shared -fPIC -fopenmp``, again without ``-fopenmp`` if that
fails) into the git-ignored ``giddy_tpu_torch/_build/``, named by a hash of
the source and the flags; the build writes a temporary file and renames it,
so processes that build at once all load a whole library. There is no
``-march=native``: a library built on one host loads on any other.

The NumPy code in ``ref/lmp.py``, ``ref/dzbv.py`` and ``util.py`` is
normative and the library gives the same bytes (tests/test_torch_native.py).
Every wrapper returns None where the library is unavailable (no g++, or
``GIDDY_TPU_NO_NATIVE=1``, the variable the reference reads too), and the
caller then takes the NumPy path. :func:`path` says which path runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from .util import GROUP, LANES

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host_lmp.cpp"
BUILD_DIR = _PKG / "_build"
# The flag sets tried in order: with OpenMP, then without.
FLAG_SETS = (
    ("-O3", "-shared", "-fPIC", "-fopenmp"),
    ("-O3", "-shared", "-fPIC"),
)

_LIB: ctypes.CDLL | None = None
_FLAGS: tuple[str, ...] | None = None
_TRIED = False
_OFF = False  # numpy_only() is active


def library_path(flags: tuple[str, ...], build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    h = hashlib.sha256(" ".join(flags).encode() + b"\0" + SOURCE.read_bytes())
    return build_dir / f"libgiddy_host_{h.hexdigest()[:16]}.so"


def build(build_dir: pathlib.Path = BUILD_DIR) -> tuple[pathlib.Path, tuple[str, ...]] | None:
    """(library, its flags): an existing build of this source, else a new
    one with the first flag set g++ accepts; None without a toolchain."""
    for flags in FLAG_SETS:
        out = library_path(flags, build_dir)
        if out.exists():
            return out, flags
    build_dir.mkdir(parents=True, exist_ok=True)
    for flags in FLAG_SETS:
        out = library_path(flags, build_dir)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *flags, str(SOURCE), "-o", str(tmp)], check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees the whole file or none
        return out, flags
    return None


def _load(path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64, i32 = ctypes.c_int64, ctypes.c_int
    for name, argtypes in {
        "lmp_pack_u32": [u32p, u32p, i64, i32],
        "lmp_unpack_u32": [u32p, u32p, i64, i32],
        "zigzag_i32": [i32p, u32p, i64],
        "unzigzag_u32": [u32p, i32p, i64],
        "dzbv_widths": [u32p, i64, u32p, i64p],
        "dzbv_fill": [u32p, u32p, i64, u32p, u32p, u32p, u32p],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built at the first call; None where it is
    unavailable or inside :func:`numpy_only`."""
    global _LIB, _FLAGS, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("GIDDY_TPU_NO_NATIVE") != "1":
            built = build()
            if built is not None:
                _LIB, _FLAGS = _load(built[0]), built[1]
    return None if _OFF else _LIB


def path() -> str:
    """``"native"`` where the wrappers run the C++ library, ``"numpy"``
    where the callers fall back to the NumPy code."""
    return "native" if get_lib() is not None else "numpy"


def flags() -> tuple[str, ...] | None:
    """The g++ flags the loaded library was built with (``-fopenmp`` among
    them where it runs threaded), or None without a library."""
    return _FLAGS if get_lib() is not None else None


@contextlib.contextmanager
def numpy_only():
    """Within the block every wrapper returns None, so the callers take the
    NumPy path (to compare or time the two in one process)."""
    global _OFF
    before, _OFF = _OFF, True
    try:
        yield
    finally:
        _OFF = before


def lmp_pack(values_u32: np.ndarray, bits: int, ng: int) -> np.ndarray | None:
    """(ng*GROUP,) uint32 values -> (ng, bits*LANES) uint32 LMP words, or
    None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(values_u32, dtype=np.uint32)
    if not 1 <= bits <= 32 or v.shape != (ng * GROUP,):
        raise ValueError(f"lmp_pack wants {ng * GROUP} values at 1..32 bits, got {v.shape} at {bits}")
    words = np.empty((ng, bits * LANES), dtype=np.uint32)
    lib.lmp_pack_u32(v, words, ng, bits)
    return words


def lmp_unpack(words: np.ndarray, bits: int, ng: int) -> np.ndarray | None:
    """(ng, bits*LANES) LMP words (any shape of that size) -> (ng*GROUP,)
    uint32 values, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)
    if not 1 <= bits <= 32 or w.shape[0] != ng * bits * LANES:
        raise ValueError(f"lmp_unpack wants {ng * bits * LANES} words at 1..32 bits, got {w.shape[0]} at {bits}")
    v = np.empty(ng * GROUP, dtype=np.uint32)
    lib.lmp_unpack_u32(w, v, ng, bits)
    return v


def dzbv_split(u: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]] | None:
    """Byte-plane split of uint32 values (the dzbv encode): (widths - 1 as
    uint32, [plane0 .. plane3] as uint32 byte values), or None if the
    library is unavailable. Plane k > 0 holds byte k of the values of width
    > k, in order; plane 0 byte 0 of all."""
    lib = get_lib()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, dtype=np.uint32).reshape(-1)
    n = u.shape[0]
    wm1 = np.empty(n, np.uint32)
    counts = np.empty(3, np.int64)
    lib.dzbv_widths(u, n, wm1, counts)
    planes = [np.empty(n, np.uint32)] + [np.empty(int(c), np.uint32) for c in counts]
    lib.dzbv_fill(u, wm1, n, *planes)
    return wm1, planes


def zigzag(d: np.ndarray) -> np.ndarray | None:
    """1-D int32 -> uint32 zigzag, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(d, dtype=np.int32).reshape(-1)
    z = np.empty(d.shape[0], np.uint32)
    lib.zigzag_i32(d, z, d.shape[0])
    return z


def unzigzag(z: np.ndarray) -> np.ndarray | None:
    """1-D uint32 zigzag -> int32, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.ascontiguousarray(z, dtype=np.uint32).reshape(-1)
    d = np.empty(z.shape[0], np.int32)
    lib.unzigzag_u32(z, d, z.shape[0])
    return d
