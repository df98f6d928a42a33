#!/usr/bin/env python3
"""Smoke run of giddy_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version and the NumPy oracle, drives
the main paths (single-column ``decode(col, device="cuda")`` at the sizes
of BASELINE.json configs[0]-[3] plus delta2 and xordelta columns, and
``scan.group_prefix_sum``), and times them.

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
from giddy_tpu_torch.kernels import _build, cumsum, delta, delta2, dict_, for_, lanes, nbit, rle, xordelta
from giddy_tpu_torch.util import GROUP

N_CHECK = 2**22 + 999  # ragged, many groups: the size that caught the reference's grid bug
LMP_SOURCE = "giddy_tpu_torch/csrc/lmp_decode.cu"
RUN_SOURCE = "giddy_tpu_torch/csrc/run_decode.cu"
# kernel name -> (wrapper, plain version, the Pallas kernel it replaces, source)
KERNELS = {
    "lmp_unpack": (nbit.lmp_unpack, lanes.lmp_unpack, "giddy_tpu/kernels/nbit.py:24", LMP_SOURCE),
    "for_unpack": (for_.for_unpack, lanes.for_unpack, "giddy_tpu/kernels/for_.py:36", LMP_SOURCE),
    "delta_decode": (delta.delta_decode, lanes.delta_decode, "giddy_tpu/kernels/delta.py:23", LMP_SOURCE),
    "dict_decode": (dict_.dict_decode, lanes.dict_decode, "giddy_tpu/kernels/dict_.py:70", LMP_SOURCE),
    # one kernel for both TPU run expansions, _chain_call (:153) and _rank_call (:216)
    "run_expand": (rle.run_expand, lanes.run_expand, "giddy_tpu/kernels/rle.py:153,216", RUN_SOURCE),
    "cumsum_rows": (cumsum.cumsum_rows, lanes.cumsum_rows, "giddy_tpu/kernels/rle.py:305", RUN_SOURCE),
    "delta2_decode": (delta2.delta2_decode, lanes.delta2_decode, "giddy_tpu/kernels/delta2.py:27", RUN_SOURCE),
    "xordelta_decode": (xordelta.xordelta_decode, lanes.xordelta_decode, "giddy_tpu/kernels/xordelta.py:18",
                        RUN_SOURCE),
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


def check_kernel(label: str, col, v: np.ndarray) -> dict:
    """Kernel vs plain version on the card (bit-exact) vs oracle vs input;
    returns the device streams."""
    streams = gtt.device_streams(col, CUDA)
    store = gtt.narrow_store_dtype(col)
    name, args = kernels.kernel_call(col, streams, store)
    wrapper, plain = KERNELS[name][:2]
    got = wrapper(*args)
    compare(label, name, got, plain(*args))
    out = as_numpy(got, col.n, col.dtype)
    check(same_bits(out, gtt.decode_ref(col)), f"{label}: {name} != oracle")
    check(same_bits(out, v), f"{label}: {name} != input")
    form = f" {','.join(sorted(streams))} {tuple(streams['vals_w'].shape)}" if "vals_w" in streams else (
        f" pos {tuple(streams['pos'].shape)}" if "pos" in streams else "")
    print(f"[kernel] {label}: {name}{form} n={col.n} store={str(store)[6:]} bit-exact vs plain, oracle, input")
    return streams


def run_column(rng, n: int, lo: int, hi: int, dtype="int32", vocab: int = 5) -> np.ndarray:
    """n values in runs of lo..hi-1, each run one of ``vocab`` random values
    of dtype (neighbouring runs may share a value, as in real flags)."""
    lengths = rng.integers(lo, hi, n // lo + 1)
    pool = rng.integers(0, 2**32, vocab, dtype=np.uint64).astype(np.uint32)
    pool = pool.view(np.float32) if dtype == "float32" else pool.astype(np.dtype(dtype))
    return np.repeat(pool[rng.integers(0, vocab, lengths.shape[0])], lengths)[:n]


def run_checks(rng, n: int) -> None:
    """rle and rpe at every run density: both stream forms, every w_pad regime."""
    long_runs = run_column(rng, n, 100, 5000)
    mid_runs = run_column(rng, n, 1, 40, vocab=1000)
    dense_runs = run_column(rng, n, 1, 8, vocab=1000)
    one_run = np.full(n, -7, np.int32)
    for scheme in ("rle", "rpe"):
        s = check_kernel(f"{scheme} runs 100-5000", gtt.encode(long_runs, scheme), long_runs)
        check("vals_w" in s and s["vals_w"].shape[-1] <= rle.RANK_MIN, f"{scheme} runs 100-5000: {list(s)}")
        s = check_kernel(f"{scheme} runs ~20", gtt.encode(mid_runs, scheme), mid_runs)
        check("vals_w" in s and rle.RANK_MIN < s["vals_w"].shape[-1] <= rle.CHAIN_HARD,
              f"{scheme} runs ~20 missed 16 < w_pad <= 128: {[tuple(t.shape) for t in s.values()]}")
        s = check_kernel(f"{scheme} runs ~4", gtt.encode(dense_runs, scheme), dense_runs)
        check("pos" in s, f"{scheme} runs ~4 did not reach the scatter form: {list(s)}")
        s = check_kernel(f"{scheme} one run", gtt.encode(one_run, scheme), one_run)
        check("vals_w" in s and s["vals_w"].shape[1] == 1, f"{scheme} one run: {list(s)}")


def scan_checks(rng, n: int) -> None:
    """delta2, xordelta and scan.group_prefix_sum."""
    ts = (np.cumsum(1000 + rng.integers(0, 4, n)) + 1_600_000_000).astype(np.int32)
    check_kernel("delta2 jittered timestamps", gtt.encode(ts, "delta2"), ts)
    walk = np.cumsum(rng.integers(-(2**24), 2**24, n)).astype(np.int32)
    col = gtt.encode(walk, "delta2")
    check(col.params["bits"] >= 25, f"delta2 walk packs to {col.params['bits']} bits, wanted >= 25")
    check_kernel(f"delta2 random walk bits={col.params['bits']}", col, walk)
    series = (np.cumsum(rng.normal(0, 1e-3, n)) + 300.0).astype(np.float32)
    check_kernel("xordelta float32 series", gtt.encode(series, "xordelta"), series)
    x = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32))
    for exclusive in (False, True):
        before = cumsum.LAUNCHES
        got = gtt.scan.group_prefix_sum(x.to(CUDA), exclusive=exclusive).view(torch.int32)
        check(cumsum.LAUNCHES == before + 1, "group_prefix_sum did not launch cumsum_rows")
        compare(f"group_prefix_sum exclusive={exclusive}", "cumsum_rows", got,
                gtt.scan.group_prefix_sum(x, exclusive=exclusive).view(torch.int32).to(CUDA))
        print(f"[kernel] group_prefix_sum exclusive={exclusive}: cumsum_rows n={n} bit-exact vs plain")


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
    run_checks(rng, n)
    scan_checks(rng, n)
    base = rng.integers(0, 2**31 - 1, n, dtype=np.int64)
    for dtype in ("int8", "int16", "uint16", "float32"):
        if dtype == "float32":
            v = rng.normal(0, 1e3, n).astype(np.float32)
        else:
            v = base.astype(np.dtype(dtype))
        v_dict = v[rng.integers(0, 500, n)]
        v_runs = run_column(rng, n, 1, 200, dtype, vocab=1000)
        for scheme in ("nbit", "dzbf", "for", "delta", "dict", "rle", "rpe", "delta2"):
            vv = v_dict if scheme == "dict" else v_runs if scheme in ("rle", "rpe") else v
            check_kernel(f"{scheme} {dtype}", gtt.encode(vv, scheme), vv)
    for scheme in ("nbit", "dzbf", "for", "delta", "dict", "rle", "rpe", "delta2", "xordelta"):
        col = gtt.encode(np.zeros(0, np.int32), scheme)
        out = gtt.decode(col, device=CUDA)
        check(out.shape == (0,) and out.dtype == torch.int32 and out.device.type == CUDA.type, f"{scheme} n=0: {out}")
        if scheme != "dict":  # d = 0: no dictionary, nothing to launch
            check_kernel(f"{scheme} n=0", col, np.zeros(0, np.int32))
    print("[kernel] all kernel checks bit-exact")


# -- phases 4 and 5 ---------------------------------------------------------


def config3_flags() -> np.ndarray:
    """BASELINE.json configs[3] as tests/test_scale.py:66-80 makes it:
    status flags 0-4 in runs of 100-5000, n = 2^26, seed 3."""
    n = 1 << 26
    rng = np.random.default_rng(3)
    v = np.zeros(n, dtype=np.int32)
    pos = 0
    while pos < n:
        ln = int(rng.integers(100, 5000))
        v[pos : pos + ln] = int(rng.integers(0, 5))
        pos += ln
    return v


def main_columns() -> list:
    """BASELINE.json configs[0]-[3] at the sizes of tests/test_scale.py,
    the configs[1] timestamps as delta2 too, and a slowly varying float32
    series as xordelta: (label, input values, encoded column), host-encoded
    and timed here."""
    rng = np.random.default_rng(0)
    v0 = rng.integers(0, 512, 2**28, dtype=np.int64).astype(np.int32)
    ts = (np.cumsum(np.random.default_rng(1).integers(0, 4, 2**26)) + 1_700_000_000).astype(np.int32)
    rng = np.random.default_rng(2)
    vocab = rng.integers(-(2**31), 2**31 - 1, 1000, dtype=np.int64).astype(np.int32)
    v2 = vocab[rng.integers(0, 1000, 2**26)]
    v3 = config3_flags()
    series = (np.cumsum(np.random.default_rng(4).normal(0, 1e-3, 2**26)) + 300.0).astype(np.float32)
    cols = []
    for label, v, scheme, opts in [
        ("configs[0] nbit 9-bit n=2^28", v0, "nbit", {"bits": 9}),
        ("configs[1] delta n=2^26", ts, "delta", {}),
        ("configs[1] for n=2^26", ts, "for", {}),
        ("configs[2] dict d=1000 n=2^26", v2, "dict", {}),
        ("configs[3] rle n=2^26", v3, "rle", {}),
        ("configs[3] rpe n=2^26", v3, "rpe", {}),
        ("configs[1] timestamps as delta2 n=2^26", ts, "delta2", {}),
        ("float32 series as xordelta n=2^26", series, "xordelta", {}),
    ]:
        t0 = time.perf_counter()
        col = gtt.encode(v, scheme, name=label, **opts)
        print(f"[encode] {label}: host encode {time.perf_counter() - t0:.2f} s "
              f"({col.nbytes_decoded / col.nbytes_compressed:.2f}x), params {col.params}")
        cols.append((label, v, col))
    return cols


def scan_input() -> torch.Tensor:
    """The input of the group_prefix_sum path: 2^26 random int32."""
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.integers(-(2**31), 2**31, 2**26, dtype=np.int64).astype(np.int32))


def same_on_card(out: torch.Tensor, v: np.ndarray) -> bool:
    """Bit-equal to the host array v (floats compared as bits)."""
    return out.shape == v.shape and torch.equal(out.view(torch.uint8), torch.from_numpy(v.view(np.uint8)).to(CUDA))


def main_path(cols: list, x: torch.Tensor) -> dict[str, int]:
    """Phase 4: each main path -- every column through decode(col,
    device=cuda), then scan.group_prefix_sum(x) -- with the launch counts
    set to 0 just before it and read just after, and its output checked
    against its input (the prefix sum against the plain version on the
    host). Returns the counts summed over the paths."""
    totals = dict.fromkeys(KERNELS, 0)

    def drive(label: str, what: str, fn) -> None:
        kernels.reset_launches()
        ok = fn()
        torch.cuda.synchronize()
        launched = {k: c for k, c in kernels.launches().items() if c}
        check(ok, f"{label}: {what} is wrong")
        check(bool(launched), f"{label}: no kernel launched")
        for k, c in launched.items():
            totals[k] += c
        print(f"[main] {label}: {what} bit-exact; launches {launched}")

    for label, v, col in cols:
        drive(label, "decode(col, device=cuda) vs input",
              lambda: same_on_card(gtt.decode(col, device=CUDA), v))
    want = gtt.scan.group_prefix_sum(x).view(torch.int32)
    for exclusive in (False, True):
        want_x = want - x if exclusive else want
        drive(f"group_prefix_sum n=2^26 exclusive={exclusive}", "scan.group_prefix_sum(x on cuda) vs plain version",
              lambda: torch.equal(gtt.scan.group_prefix_sum(x.to(CUDA), exclusive=exclusive).view(torch.int32),
                                  want_x.to(CUDA)))
    return totals


def time_kernel(label: str, smi: str, name: str, args: tuple, nbytes: int, e2e, e2e_what: str, tail: str) -> dict:
    """Phase 5: the kernel on resident inputs (also held against its plain
    version at this shape), a same-size copy_, the plain version, and the
    end-to-end call; ``tail`` adds the uploads measured by the caller."""
    wrapper, plain = KERNELS[name][:2]
    compare(label, name, wrapper(*args), plain(*args))
    k_ms = cuda_ms(lambda: wrapper(*args))
    src = torch.empty(nbytes // 4, dtype=torch.int32, device=CUDA)
    dst = torch.empty_like(src)
    c_ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    p_ms = cuda_ms(lambda: plain(*args), runs=10, warmup=1)
    e_ms = host_ms(e2e)
    k_gbs, c_gbs = nbytes / k_ms / 1e6, nbytes / c_ms / 1e6
    print(f"[time] {label} on {smi}: kernel {name} {k_ms:.4f} ms = {k_gbs:.1f} GB/s decoded; "
          f"copy_ of the same {nbytes} B {c_ms:.4f} ms = {c_gbs:.1f} GB/s; kernel/copy {k_gbs / c_gbs:.3f}; "
          f"plain PyTorch {p_ms:.4f} ms; end-to-end {e2e_what} {e_ms:.3f} ms; {tail} "
          f"(medians of 20 / 20 / 10 / 10 / 10 / 10 runs)")
    torch.cuda.empty_cache()
    return {"ms": k_ms, "plain_ms": p_ms}


def time_column(label, v, col, smi) -> tuple[str, dict]:
    """Phase 5 for a column: end-to-end decode(col) includes host prep and
    the upload; beside it the upload of the streams alone and of the raw
    column it stands against."""
    name, args = kernels.kernel_call(col, gtt.device_streams(col, CUDA), gtt.narrow_store_dtype(col))
    u_ms = host_ms(lambda: gtt.device_streams(col, CUDA))
    r_ms = host_ms(lambda: torch.from_numpy(v).to(CUDA))
    tail = (f"host prep + H2D of the {col.nbytes_compressed} B of streams alone {u_ms:.3f} ms; "
            f"H2D of the raw column {r_ms:.3f} ms")
    return name, time_kernel(label, smi, name, args, col.nbytes_decoded,
                             lambda: gtt.decode(col, device=CUDA), "decode(col)", tail)


def time_scan(x: torch.Tensor, smi: str) -> tuple[str, dict]:
    """Phase 5 for scan.group_prefix_sum on a resident tensor."""
    xc = x.to(CUDA)
    rows = xc.view(-1, GROUP)  # 2^26 is whole groups
    r_ms = host_ms(lambda: x.to(CUDA))
    return "cumsum_rows", time_kernel(
        "group_prefix_sum n=2^26", smi, "cumsum_rows", (rows,), x.numel() * 4,
        lambda: gtt.scan.group_prefix_sum(xc), "group_prefix_sum(x resident)",
        f"H2D of the raw column {r_ms:.3f} ms")


def main() -> int:
    smi = environment()
    build()
    kernel_checks()
    cols = main_columns()
    x = scan_input()
    counts = main_path(cols, x)
    timings = dict(time_column(label, v, col, smi) for label, v, col in cols)
    timings.update([time_scan(x, smi)])
    for name, count in counts.items():
        check(count >= 1, f"{name} was launched {count} times on the main path")
    rows = [
        {"name": name, "route": "cuda", "source": KERNELS[name][3], "replaces": KERNELS[name][2],
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
