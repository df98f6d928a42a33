#!/usr/bin/env python3
"""Smoke run of giddy_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version and the NumPy oracle, drives
the main path (single-column ``decode(col, device="cuda")``) at the sizes
of BASELINE.json configs[0]-[2], and times it.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX. Every check
raises on failure, so the exit code is 0 only when every phase passed. The
last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import _build, delta, dict_, for_, lanes, nbit
from giddy_tpu_torch.util import GROUP

N_CHECK = 2**22 + 999  # ragged, many groups: the size that caught the reference's grid bug
SOURCE = "giddy_tpu_torch/csrc/lmp_decode.cu"
# kernel name -> (wrapper, plain version, the Pallas kernel it replaces)
KERNELS = {
    "lmp_unpack": (nbit.lmp_unpack, lanes.lmp_unpack, "giddy_tpu/kernels/nbit.py:24"),
    "for_unpack": (for_.for_unpack, lanes.for_unpack, "giddy_tpu/kernels/for_.py:36"),
    "delta_decode": (delta.delta_decode, lanes.delta_decode, "giddy_tpu/kernels/delta.py:23"),
    "dict_decode": (dict_.dict_decode, lanes.dict_decode, "giddy_tpu/kernels/dict_.py:70"),
}
MAX_ABS_ERR = {name: 0 for name in KERNELS}
CUDA = torch.device("cuda")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def as_numpy(t: torch.Tensor, n: int, dtype: str) -> np.ndarray:
    """First n values of a payload tensor, as NumPy of the logical dtype."""
    host = t.reshape(-1)[:n].cpu().numpy()
    return host.view(np.dtype(dtype)) if host.dtype.itemsize == np.dtype(dtype).itemsize else host


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def compare(label: str, name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Kernel output vs its plain version's: bit-exact, and record the error."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and torch.equal(got, want), f"{label}: {name} != plain version")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name], err)


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
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


def host_ms(fn, runs: int = 10, warmup: int = 1) -> float:
    """Median host-clock time of fn() through a device synchronise."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- phase 1 ----------------------------------------------------------------


def environment() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# -- phase 2 ----------------------------------------------------------------


def build() -> None:
    t0 = time.perf_counter()
    _build.lib()
    nvcc = f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds is not None else "cached"
    print(f"[build] {_build.library_path().name}: {nvcc}, ready in {time.perf_counter() - t0:.1f} s")


# -- phase 3 ----------------------------------------------------------------


def check_kernel(label: str, col, v: np.ndarray) -> None:
    """Kernel vs plain version on the card (bit-exact) vs oracle vs input."""
    streams = gtt.device_streams(col, CUDA)
    store = gtt.narrow_store_dtype(col)
    name, args = kernels.kernel_call(col, streams, store)
    wrapper, plain = KERNELS[name][:2]
    got = wrapper(*args)
    compare(label, name, got, plain(*args))
    out = as_numpy(got, col.n, col.dtype)
    check(same_bits(out, gtt.decode_ref(col)), f"{label}: {name} != oracle")
    check(same_bits(out, v), f"{label}: {name} != input")
    print(f"[kernel] {label}: {name} n={col.n} store={str(store)[6:]} bit-exact vs plain, oracle, input")


def dict_column(rng, d: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    vocab = rng.permutation(np.arange(d, dtype=np.int64) * 65_537 - 2**31 + 12_345).astype(np.int32)
    return vocab[rng.integers(0, d, n)], vocab


def kernel_checks(n: int = N_CHECK) -> None:
    rng = np.random.default_rng(2026)
    for bits in (1, 7, 9, 16, 17, 31, 32):
        v = rng.integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
        check_kernel(f"nbit B={bits}", gtt.encode(v, "nbit", bits=bits), v)
    for width in (1, 2, 3, 4):
        v = rng.integers(0, 2 ** (8 * width), n, dtype=np.uint64).astype(np.uint32).view(np.int32)
        check_kernel(f"dzbf width={width}", gtt.encode(v, "dzbf", width=width), v)
    v = (1_700_000_000 + rng.integers(0, 4096, n)).astype(np.int32)
    check_kernel("for", gtt.encode(v, "for"), v)
    check_kernel("for frame_len=2*GROUP", gtt.encode(v, "for", frame_len=2 * GROUP), v)
    ts = (np.cumsum(rng.integers(0, 16, n)) + 1_600_000_000).astype(np.int32)
    check_kernel("delta timestamps", gtt.encode(ts, "delta"), ts)
    walk = np.cumsum(rng.integers(-(2**24), 2**24, n)).astype(np.int32)
    col = gtt.encode(walk, "delta")
    check(col.params["bits"] >= 25, f"delta walk packs to {col.params['bits']} bits, wanted >= 25")
    check_kernel(f"delta negative steps bits={col.params['bits']}", col, walk)
    for d in (1, 40, 1000, 2049, 16384, 65536):
        v, vocab = dict_column(rng, d, n)
        mode = "shared" if dict_.dict_in_shared(d) else "global"
        check_kernel(f"dict d={d} ({mode})", gtt.encode(v, "dict", dictionary=vocab), v)
    base = rng.integers(0, 2**31 - 1, n, dtype=np.int64)
    for dtype in ("int8", "int16", "uint16", "float32"):
        if dtype == "float32":
            v = rng.normal(0, 1e3, n).astype(np.float32)
        else:
            v = base.astype(np.dtype(dtype))
        v_dict = v[rng.integers(0, 500, n)]
        for scheme in ("nbit", "dzbf", "for", "delta", "dict"):
            vv = v_dict if scheme == "dict" else v
            check_kernel(f"{scheme} {dtype}", gtt.encode(vv, scheme), vv)
    for scheme in ("nbit", "dzbf", "for", "delta", "dict"):
        col = gtt.encode(np.zeros(0, np.int32), scheme)
        out = gtt.decode(col, device=CUDA)
        check(out.shape == (0,) and out.dtype == torch.int32 and out.device.type == CUDA.type, f"{scheme} n=0: {out}")
        if scheme != "dict":  # d = 0: no dictionary, nothing to launch
            check_kernel(f"{scheme} n=0", col, np.zeros(0, np.int32))
    print("[kernel] all kernel checks bit-exact")


# -- phases 4 and 5 ---------------------------------------------------------


def main_columns() -> list:
    """BASELINE.json configs[0]-[2] at the sizes of tests/test_scale.py:
    (label, input values, encoded column), host-encoded and timed here."""
    rng = np.random.default_rng(0)
    v0 = rng.integers(0, 512, 2**28, dtype=np.int64).astype(np.int32)
    ts = (np.cumsum(np.random.default_rng(1).integers(0, 4, 2**26)) + 1_700_000_000).astype(np.int32)
    rng = np.random.default_rng(2)
    vocab = rng.integers(-(2**31), 2**31 - 1, 1000, dtype=np.int64).astype(np.int32)
    v2 = vocab[rng.integers(0, 1000, 2**26)]
    cols = []
    for label, v, scheme, opts in [
        ("configs[0] nbit 9-bit n=2^28", v0, "nbit", {"bits": 9}),
        ("configs[1] delta n=2^26", ts, "delta", {}),
        ("configs[1] for n=2^26", ts, "for", {}),
        ("configs[2] dict d=1000 n=2^26", v2, "dict", {}),
    ]:
        t0 = time.perf_counter()
        col = gtt.encode(v, scheme, name=label, **opts)
        print(f"[encode] {label}: host encode {time.perf_counter() - t0:.2f} s "
              f"({col.nbytes_decoded / col.nbytes_compressed:.2f}x), params {col.params}")
        cols.append((label, v, col))
    return cols


def main_path(cols: list) -> dict[str, int]:
    """Phase 4: every main-path column through decode(col, device=cuda),
    checked against its input; returns the launch counts of this run."""
    kernels.reset_launches()
    for label, v, col in cols:
        before = kernels.launches()
        out = gtt.decode(col, device=CUDA)
        torch.cuda.synchronize()
        after = kernels.launches()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        check(out.shape == (col.n,) and out.device.type == CUDA.type, f"{label}: shape {tuple(out.shape)}")
        check(torch.equal(out, torch.from_numpy(v).to(CUDA)), f"{label}: decode != input")
        check(launched and min(launched.values()) >= 1, f"{label}: no kernel launched")
        print(f"[main] {label}: decode(col, device=cuda) bit-exact vs input; launches {launched}")
        del out
    return kernels.launches()


def time_column(label, v, col, smi) -> tuple[str, dict]:
    """Phase 5: the kernel on resident streams (also held against its plain
    version at this shape), a same-size copy_, the plain version,
    end-to-end decode(col) including host prep and the upload, and the
    upload of the raw column it stands against."""
    streams = gtt.device_streams(col, CUDA)
    name, args = kernels.kernel_call(col, streams, gtt.narrow_store_dtype(col))
    wrapper, plain = KERNELS[name][:2]
    compare(label, name, wrapper(*args), plain(*args))
    nbytes = col.nbytes_decoded
    k_ms = cuda_ms(lambda: wrapper(*args))
    src = torch.empty(nbytes // 4, dtype=torch.int32, device=CUDA)
    dst = torch.empty_like(src)
    c_ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    p_ms = cuda_ms(lambda: plain(*args), runs=10, warmup=1)
    u_ms = host_ms(lambda: gtt.device_streams(col, CUDA))
    e_ms = host_ms(lambda: gtt.decode(col, device=CUDA))
    r_ms = host_ms(lambda: torch.from_numpy(v).to(CUDA))
    k_gbs, c_gbs = nbytes / k_ms / 1e6, nbytes / c_ms / 1e6
    print(f"[time] {label} on {smi}: kernel {name} {k_ms:.4f} ms = {k_gbs:.1f} GB/s decoded; "
          f"copy_ of the same {nbytes} B {c_ms:.4f} ms = {c_gbs:.1f} GB/s; kernel/copy {k_gbs / c_gbs:.3f}; "
          f"plain PyTorch {p_ms:.4f} ms; end-to-end decode(col) {e_ms:.3f} ms; host prep + H2D of the "
          f"{col.nbytes_compressed} B of streams alone {u_ms:.3f} ms; H2D of the raw column {r_ms:.3f} ms "
          f"(medians of 20 / 20 / 10 / 10 / 10 / 10 runs)")
    torch.cuda.empty_cache()
    return name, {"ms": k_ms, "plain_ms": p_ms}


def main() -> int:
    smi = environment()
    build()
    kernel_checks()
    cols = main_columns()
    counts = main_path(cols)
    timings = dict(time_column(label, v, col, smi) for label, v, col in cols)
    for name, count in counts.items():
        check(count >= 1, f"{name} was launched {count} times on the main path")
    rows = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name][2],
         "launches": counts[name], "max_abs_err": MAX_ABS_ERR[name],
         "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
