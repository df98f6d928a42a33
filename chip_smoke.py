#!/usr/bin/env python3
"""Smoke run of giddy_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
and the C++ host codec (the ``[native]`` phase: the codec loaded, held bit
for bit to the NumPy path at full width, and its host seconds beside the
NumPy path's), holds each kernel against its plain PyTorch version and the
NumPy oracle, drives
the main paths (single-column ``decode(col, device="cuda")`` at the sizes
of BASELINE.json configs[0]-[3] plus delta2 and xordelta columns,
``scan.group_prefix_sum``, the mixed container of configs[4] through
``decode_columns``, a cascade (RLE_DICTIONARY) column, an rle column at
the cell of the reference's ``_rank_call`` (K5's rank form; the kernels
line counts K5's launches by form), model (poly2),
bitmap and alp columns, alone and through ``decode_columns``, and a dzbv
column in each of its three stream forms, and beside configs[4] through
``decode_columns``), the scan layer (``query.count_where`` /
``filter_bitmap`` through the fused filter K16, ``count_between`` of an
rle column through the run-table filter K19, ``aggregate.sum_`` /
``min_`` / ``max_`` / ``avg_`` through the fused aggregate K17, nullable
and dictionary columns, one general-path column; K16 and K17 also held
against their plain versions at every packed width, K13 and K14 at every
tile stride and row width), device encode (the
configs[0]-[3] columns through ``kernels.encode``: ``encode_nbit_device``,
``delta_streams_device`` / ``for_streams_device``, ``encode_dict_device``
and ``encode_rle_device``, the LMP pack K18 under all but the last, each
held byte for byte to the host encoder's column), the analytic phase
(64-bit and string columns, partial decode, zone maps, GROUP BY and top-k
on a TPC-H lineitem-shaped table at n = 2^26 and an orders-shaped one at
n = 2^24: ``decode`` of wide and strdict columns, the wide branches of
``query`` and ``aggregate``, ``zonemap.count_where_pruned`` /
``searchsorted``, ``query.select_where`` / ``partial.take``,
``groupby.group_reduce``, ``topk.top_k`` and the ``strings`` scans, each
held exactly against NumPy on the input), the tables phase (a TPC-H
customer table at SF 11 through ``Table.from_arrays`` and the advisor; the
customer-orders ``semi_join`` / ``anti_join`` / ``join_indices`` /
``Table.join``; ``count``, ``where_all``/``where_any``, ``agg``, ``groupby``,
``select``, ``top_k`` and ``sort_by`` on the Tables; a four-partition
lineitem ``Dataset`` with ``_plan``, ``count``, ``agg``, ``groupby``,
``select`` and ``compact``; ``stream_count_where`` / ``decode_streamed`` /
``stream_decode`` with their peak card memory; ``advisor.suggest(...,
measure=True)``; the CLI in-process; ``selftest.run_selftest`` with the
traffic audit of every core scheme), the dist
phase (the sharded layer: ``dist.decode_columns_sharded`` of configs[4] on
``dist.default_mesh()`` and on ``dist.Mesh([cuda:0] * 4)``, whose four
shards launch each kernel four times; ``dist_query`` count, sum and min of
configs[0], ``group_reduce_sharded`` and the wide ``sum_sharded`` on the
lineitem columns, ``Table.join(mesh=)`` and ``Dataset.count(mesh=)``; a
two-rank torch.distributed (gloo) drill on the card), the examples phase
(examples/compression_tour_torch.py and examples/tpch_demo_torch.py, each
one's ``main`` at 2^20 on the card, its own asserts the check), the bench
phase (every bench kind of bench_torch.py prepared on the card at 2^20 and
held to the oracle; bench_torch.py's main at 2^24, its trials in fresh
processes, and scripts/multihost_bench_torch.py as one process and as two
gloo ranks on cuda:0, their JSON lines parsed), and times them.
Kernel bounds take the card's memory rate from ``roofline.chip_bw`` and
its issue rate from ``roofline.chip_rates``. Last, the ``[ops]`` phase
checks the card's SM count against ``roofline.SM_CLOCK`` and takes the
SASS census of every kernel at the cell it timed (``roofline.sass_census``
on the built library's ``cuobjdump -sass``): instructions a value by pipe,
the budget memory leaves them and the busiest pipe's floor beside the
measured time, which no floor may exceed.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX. Every check
raises on failure, so the exit code is 0 only when every phase passed. The
last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import (
    aggregate, groupby, kernels, native, nulls, partial, query, roofline, stream, strings, topk, wide, zonemap,
)
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.kernels import (
    _build, agg, alp, bitmap, cascade, cumsum, delta, delta2, dict_, dzbv, encode, filter_, for_, lanes, model, nbit,
    patch, rle, run_filter, xordelta,
)
from giddy_tpu_torch.ref import dzbv as ref_dzbv
from giddy_tpu_torch.ref import lmp as ref_lmp
from giddy_tpu_torch.ref.cascade import INNER_SCHEMES
from giddy_tpu_torch.util import GROUP, num_groups, pad_to_groups, unzigzag, zigzag

T_START = time.perf_counter()  # the script's wall time is read from here, after its imports

N_CHECK = 2**22 + 999  # ragged, many groups: the size that caught the reference's grid bug
LMP_SOURCE = "giddy_tpu_torch/csrc/lmp_decode.cu"
RUN_SOURCE = "giddy_tpu_torch/csrc/run_decode.cu"
PATCH_SOURCE = "giddy_tpu_torch/csrc/patch_decode.cu"
EPILOGUE_SOURCE = "giddy_tpu_torch/csrc/epilogue_decode.cu"
DZBV_SOURCE = "giddy_tpu_torch/csrc/dzbv_decode.cu"
SCAN_SOURCE = "giddy_tpu_torch/csrc/scan_epilogue.cu"
ENCODE_SOURCE = "giddy_tpu_torch/csrc/encode.cu"
DZBV_FORMS = {"tile": "dzbv_tile_decode", "group": "dzbv_group_decode", "plane": "dzbv_plane_decode"}
OPS = ("eq", "ne", "lt", "le", "gt", "ge")
# K16 and K17 write one word (or one to three partials) a lane, K18 B
# words a lane: their operations count per value read, n_pad, not per word
# written.
PER_INPUT_VALUE = ("filter_fold", "agg_fold", "lmp_pack")
# K18's operations a value: shift and OR, and a second shift and OR where a
# slot straddles (3 on average); +1 for the FOR subtract; +6 for delta (the
# subtract, two compares and a select, the zigzag's shift and XOR).
PACK_OPS = {"none": 3, "for_sub": 4, "delta_zigzag": 9}


def dzbv_ops(args) -> int:
    """Integer operations a value of a dzbv decode: the unpacks of the width
    code and of plane 0 (6), and for each plane present the compare, the
    rank (ballot mask, popcount, add), the byte's address (3), its shift and
    mask (2) and its shift and OR into the value (2)."""
    return 6 + 10 * sum(t is not None for t in args[2])


# kernel name -> (wrapper, plain version, the Pallas kernel it replaces,
# source, integer operations per value the function needs at the least, or
# a function of the wrapper's arguments that gives them)
KERNELS = {
    # shift, OR, mask
    "lmp_unpack": (nbit.lmp_unpack, lanes.lmp_unpack, "giddy_tpu/kernels/nbit.py:24", LMP_SOURCE, 3),
    "for_unpack": (for_.for_unpack, lanes.for_unpack, "giddy_tpu/kernels/for_.py:36", LMP_SOURCE, 4),
    # unpack, unzigzag (3), one add of the scan
    "delta_decode": (delta.delta_decode, lanes.delta_decode, "giddy_tpu/kernels/delta.py:23", LMP_SOURCE, 7),
    "dict_decode": (dict_.dict_decode, lanes.dict_decode, "giddy_tpu/kernels/dict_.py:70", LMP_SOURCE, 4),
    # one kernel for both TPU run expansions, _chain_call (:153) and _rank_call (:216)
    "run_expand": (rle.run_expand, lanes.run_expand, "giddy_tpu/kernels/rle.py:153,216", RUN_SOURCE, 1),
    "cumsum_rows": (cumsum.cumsum_rows, lanes.cumsum_rows, "giddy_tpu/kernels/rle.py:305", RUN_SOURCE, 1),
    "delta2_decode": (delta2.delta2_decode, lanes.delta2_decode, "giddy_tpu/kernels/delta2.py:27", RUN_SOURCE, 9),
    "xordelta_decode": (xordelta.xordelta_decode, lanes.xordelta_decode, "giddy_tpu/kernels/xordelta.py:18",
                        RUN_SOURCE, 4),
    "patched_decode": (patch.patched_decode, lanes.patched_decode, "giddy_tpu/kernels/patch.py:34", PATCH_SOURCE, 4),
    # the LUT stage of K1/K2/K3/K5/K6/K7 (gt::Lut): (inner kernel name, its arguments with the table)
    "cascade_lut": (cascade.cascade_lut, lambda name, args: getattr(lanes, name)(*args),
                    "giddy_tpu/kernels/cascade.py:30", "giddy_tpu_torch/csrc/lmp.cuh", 2),
    # unpack, unzigzag, p and a + b*p (+ c*p*p), the add
    "model_decode": (model.model_decode, lanes.model_decode, "giddy_tpu/kernels/model.py:56", EPILOGUE_SOURCE,
                     lambda args: 8 if args[3] is None else 10),
    # shift, and, multiply-add for each of the d planes
    "bitmap_decode": (bitmap.bitmap_decode, lanes.bitmap_decode, "giddy_tpu/kernels/bitmap.py:51",
                      EPILOGUE_SOURCE, lambda args: 3 * args[1].numel()),
    # two unpacks, the ref add, convert, multiply, unzigzag, the add
    "alp_decode": (alp.alp_decode, lanes.alp_decode, "giddy_tpu/kernels/alp.py:47", EPILOGUE_SOURCE, 13),
    # one kernel template, a kernel for each stream form (K15: count kernel, cumsum, decode)
    "dzbv_tile_decode": (dzbv.dzbv_tile_decode, lanes.dzbv_tile_decode, "giddy_tpu/kernels/dzbv.py:340",
                         DZBV_SOURCE, dzbv_ops),
    "dzbv_group_decode": (dzbv.dzbv_group_decode, lanes.dzbv_group_decode, "giddy_tpu/kernels/dzbv.py:461",
                          DZBV_SOURCE, dzbv_ops),
    "dzbv_plane_decode": (dzbv.dzbv_plane_decode, lanes.dzbv_plane_decode, "giddy_tpu/kernels/dzbv.py:512,519",
                          DZBV_SOURCE, dzbv_ops),
    # unpack (3), the ref add, the key (up to 2), the compare, its shift and OR into the word
    "filter_fold": (filter_.filter_fold, lanes.filter_fold, "giddy_tpu/query.py:72", SCAN_SOURCE, 9),
    # unpack (3), the ref add, then for the sum the position and validity tests (3), the
    # select, the sign bit (2) and its count, the add and its carry (2); for min/max the
    # position test, the key (up to 2) and the min or max
    "agg_fold": (agg.agg_fold, lanes.agg_fold, "giddy_tpu/aggregate.py:104", SCAN_SOURCE,
                 lambda args: 14 if args[7] == "sum" else 8),
    "lmp_pack": (encode.lmp_pack, lanes.lmp_pack, "giddy_tpu/kernels/encode.py:45", ENCODE_SOURCE,
                 lambda args: PACK_OPS[args[2]]),
    # no Pallas kernel: the reference's general path (decode, compare, pack); a word
    # a lane takes its tile's bits from h[0] and is stored
    "run_filter": (run_filter.run_filter, lanes.run_filter, "none (giddy_tpu/query.py:310-320, decode and compare)",
                   SCAN_SOURCE, 2),
}
MAX_ABS_ERR = {name: 0 for name in KERNELS}
CUDA = torch.device("cuda")


def kernel_call(col, streams: dict, store) -> tuple[str, tuple]:
    """(KERNELS row, wrapper arguments) that decode ``col``: a cascade
    column is the cascade_lut row, its arguments the inner kernel's."""
    name, args = kernels.kernel_call(col, streams, store)
    return ("cascade_lut", (name, args)) if col.scheme == "cascade" else (name, args)


def tensors(args) -> list[torch.Tensor]:
    """Every tensor among (nested) wrapper arguments."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, tuple):
            out.extend(tensors(a))
    return out


def bound_bytes(args: tuple, out, in_bytes: int | None = None) -> int:
    """The bytes of a call: each input read once, each output written once.
    ``out`` is the output tensor, or K17's tuple of partials. ``in_bytes``,
    when given, stands for the arguments' bytes: the input the function
    needs where the arguments hold padding it does not (see run_bytes)."""
    outs = out if isinstance(out, tuple) else (out,)
    if in_bytes is None:
        in_bytes = sum(t.numel() * t.element_size() for t in tensors(args))
    return in_bytes + sum(t.numel() * t.element_size() for t in outs)


def bound_values(name: str, args: tuple, out) -> int:
    """The values a call counts its operations by: those it writes, or for
    K16, K17 and K18 those it reads (n_pad)."""
    outs = out if isinstance(out, tuple) else (out,)
    return args[0].shape[0] * GROUP if name in PER_INPUT_VALUE else outs[0].numel()


def bound(name: str, args: tuple, out, in_bytes: int | None = None) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take for
    this call, the larger of its bytes (bound_bytes) over the memory rate
    and its integer operations (KERNELS' count, the least the function
    needs) over the issue rate (roofline.chip_rates: four warp instructions
    a clock an SM, the most that any mix of the integer pipes can retire;
    the ALU pipe alone takes half of it), and which of the two it is."""
    by_bytes = bound_bytes(args, out, in_bytes) / roofline.chip_bw() * 1e3
    ops = KERNELS[name][4]
    issue = roofline.chip_rates()["issue"]
    by_ops = (ops(args) if callable(ops) else ops) * bound_values(name, args, out) / issue * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def as_numpy(t: torch.Tensor, n: int, dtype: str) -> np.ndarray:
    """First n values of a payload tensor, as NumPy of the logical dtype."""
    host = t.reshape(-1)[:n].cpu().numpy()
    return host.view(np.dtype(dtype)) if host.dtype.itemsize == np.dtype(dtype).itemsize else host


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def compare(label: str, name: str, got, want) -> None:
    """Kernel output vs its plain version's (tensors, or K17's tuples of
    partials): bit-exact, and record the error."""
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    check(len(got) == len(want), f"{label}: {name} gave {len(got)} outputs, its plain version {len(want)}")
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and torch.equal(g, w), f"{label}: {name} != plain version")
        err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name], err)


def cuda_ms(fn, runs: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Median of ``runs`` CUDA-event timings of fn(), after warm-up.
    ``queued`` puts a ~10 ms sleep kernel first, so that every run is
    queued before the card reaches it: for a kernel shorter than the
    host's time to launch it, that gap then stays out of the events."""
    for _ in range(warmup):
        fn()
    if queued:
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


# -- phase 2b: the C++ host codec ----------------------------------------------

NATIVE_S: dict[str, tuple[float, float]] = {}  # host step -> (C++ codec s, NumPy path s), one run each


def both_paths(label: str, fn):
    """fn() through the C++ host codec, then through the NumPy path, one run
    each on the host clock: (its result on each path)."""
    t0 = time.perf_counter()
    nat = fn()
    t1 = time.perf_counter()
    with native.numpy_only():
        ref = fn()
    t2 = time.perf_counter()
    NATIVE_S[label] = (t1 - t0, t2 - t1)
    print(f"[native] {label}: C++ {t1 - t0:.3f} s, NumPy {t2 - t1:.3f} s ({(t2 - t1) / (t1 - t0):.1f}x)")
    return nat, ref


def same_streams(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(
        got[k].dtype == w.dtype and same_bits(np.asarray(got[k]), np.asarray(w)) for k, w in want.items())


def configs0_values() -> np.ndarray:
    """BASELINE.json configs[0]: 2^28 values under 512, seed 0."""
    return np.random.default_rng(0).integers(0, 512, 2**28, dtype=np.int64).astype(np.int32)


def dzbv_values() -> np.ndarray:
    """The dzbv column: datagen's widths 1-4 bytes, near uniform (planes 1,
    2, 3 hold ~75, 50, 25% of the values), 2^26 values, seed 13."""
    return gen_column("dzbv", 2**26, np.random.default_rng(13))


def native_phase(v0: np.ndarray, vd: np.ndarray) -> None:
    """The C++ host codec is built and loaded (not the NumPy fallback), and
    at full width gives the NumPy path's bytes: configs[0]'s encode (the
    LMP pack at 9 bits) and its oracle decode (the unpack), zigzag and back
    on a 2^26 wrapping walk, the dzbv split, encode and group-row prep of
    the 2^26 dzbv column; each step's host seconds on both paths."""
    check(native.path() == "native", f"the C++ host codec did not load: the host path is {native.path()}")
    print(f"[native] {native.library_path(native.flags()).name}: g++ {' '.join(native.flags())}")
    # a first call of each entry point, small, starts the thread pool before the timed runs
    gtt.decode_ref(gtt.encode(vd[: 8 * GROUP], "dzbv"))
    unzigzag(zigzag(vd[: 8 * GROUP]))
    nat, ref = both_paths("configs[0] nbit 9-bit n=2^28 encode", lambda: gtt.encode(v0, "nbit", bits=9))
    check(same_column(nat, ref), "configs[0] encode: C++ codec != NumPy path")
    col = nat
    del ref
    nat, ref = both_paths("configs[0] nbit 9-bit n=2^28 oracle decode (unpack)", lambda: gtt.decode_ref(col))
    check(same_bits(nat, ref) and same_bits(nat, v0), "configs[0] unpack: C++ codec != NumPy path or input")
    del nat, ref, col
    walk = wrapping_walk(np.random.default_rng(15), 2**26)
    nat, ref = both_paths("zigzag of a wrapping walk n=2^26", lambda: zigzag(walk))
    check(same_bits(nat, ref), "zigzag: C++ codec != NumPy path")
    back, back_ref = both_paths("unzigzag of it", lambda: unzigzag(nat))
    check(same_bits(back, back_ref) and same_bits(back, walk), "unzigzag: C++ codec != NumPy path or input")
    del walk, nat, ref, back, back_ref
    (wm1, planes), (wm1_ref, planes_ref) = both_paths("dzbv split n=2^26", lambda: ref_dzbv.split(vd.view(np.uint32)))
    check(same_bits(wm1, wm1_ref) and len(planes) == 4 and all(same_bits(a, b) for a, b in zip(planes, planes_ref)),
          "dzbv split: C++ codec != NumPy path")
    del wm1, planes, wm1_ref, planes_ref
    nat, ref = both_paths("dzbv n=2^26 encode", lambda: gtt.encode(vd, "dzbv"))
    check(same_column(nat, ref), "dzbv encode: C++ codec != NumPy path")
    prep, prep_ref = both_paths("dzbv n=2^26 prep (kernels/dzbv.prep)", lambda: dzbv.prep(nat))
    check(dzbv_form(prep).startswith("group-row form") and same_streams(prep, prep_ref),
          f"dzbv prep into {dzbv_form(prep)}: not the group-row form, or C++ codec != NumPy path")


# -- phase 3 ----------------------------------------------------------------


def check_kernel(label: str, col, v: np.ndarray, host_streams: dict | None = None) -> dict:
    """Kernel vs plain version on the card (bit-exact) vs oracle vs input, on
    the prepped streams or on ``host_streams``; returns the device streams."""
    streams = gtt.device_streams(col, CUDA) if host_streams is None else gtt.upload(host_streams, CUDA)
    store = gtt.narrow_store_dtype(col)
    name, args = kernel_call(col, streams, store)
    wrapper, plain = KERNELS[name][:2]
    got = wrapper(*args)
    compare(label, name, got, plain(*args))
    out = as_numpy(got, col.n, col.dtype)
    check(same_bits(out, gtt.decode_ref(col)), f"{label}: {name} != oracle")
    check(same_bits(out, v), f"{label}: {name} != input")
    runs = {k.removeprefix("c_"): t for k, t in streams.items()}
    form = f" vals_w {tuple(runs['vals_w'].shape)}" if "vals_w" in runs else (
        f" pos {tuple(runs['pos'].shape)}" if "pos" in runs else "")
    if col.scheme == "dzbv":
        form = " " + dzbv_form(streams)
    inner = f" over {args[0]}" if name == "cascade_lut" else ""
    print(f"[kernel] {label}: {name}{inner}{form} n={col.n} store={str(store)[6:]} bit-exact vs plain, oracle, input")
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
    run_table_checks(np.random.default_rng(98), num_groups(n))  # its own seed: the later phases' data stays


def edge_run_tables(rng, w_pad: int, tiles: int, ng: int) -> tuple[np.ndarray, np.ndarray]:
    """(ends_w, vals_w) int32 of ng * tiles tiles of W = GROUP // tiles, in
    the host prep's form (ends non-decreasing, at most w_pad - 1 below W,
    the rest W). Row i takes edge case i % 6: random ends, equal ends (the
    last counted entry among them), ends of 0, no end (an all-pad tile),
    runs of one (w_pad - 1 ends in 128 positions: more than 32 in one step
    of a K5 warp), w_pad - 1 consecutive ends across position 1024 (a warp's
    span edge); the last group is all pad past its middle tile, as a ragged
    column's."""
    width = GROUP // tiles
    ends = np.full((ng * tiles, w_pad), width, np.int64)
    for i in range(ng * tiles):
        if i >= (ng - 1) * tiles + tiles // 2:
            continue
        case = i % 6
        if case == 0:
            real = rng.integers(0, width, rng.integers(0, w_pad))
        elif case == 1:
            real = rng.choice([0, 1, width // 2, width // 2 + 1, width - 1], w_pad - 1)
        elif case == 2:
            real = np.concatenate([np.zeros(w_pad // 2, np.int64), rng.integers(0, width, w_pad // 2 - 1)])
        elif case == 3:
            real = np.zeros(0, np.int64)
        elif case == 4:
            real = np.arange(1, w_pad)
        else:
            real = min(width - w_pad, max(0, 1024 - w_pad // 2)) + np.arange(w_pad - 1)
        ends[i, : real.shape[0]] = np.sort(real)
    vals = rng.integers(0, 2**32, ends.shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return ends.astype(np.int32), vals


def run_table_checks(rng, ng: int) -> None:
    """K5 against its plain version on edge_run_tables over ng groups at
    every w_pad of both forms (the chain form's 8 and 16, the rank form's
    32, 64 and 128) and T of 1, 32 and 64 (W of 32768, 1024, 512), at 4-
    and 1-byte stores, and with a cascade table (codes past its 1000
    entries clamp) at 2 bytes; K19 on the same tables against the general
    path on the card."""
    lut = card_words(rng, (1000,))
    launches = k19 = 0
    for w_pad in (8, 16, 32, 64, 128):
        for tiles in (1, 32, 64):
            ends, vals = edge_run_tables(rng, w_pad, tiles, ng)
            e, v = torch.from_numpy(ends).to(CUDA), torch.from_numpy(vals).to(CUDA)
            codes = torch.from_numpy((vals.view(np.uint32) % 1200).astype(np.int32)).to(CUDA)
            for store, table, vv in ((torch.int32, None, v), (torch.uint8, None, v), (torch.int16, lut, codes)):
                compare(f"K5 edge tables w_pad {w_pad} T {tiles} store {store} table {table is not None}",
                        "run_expand", rle.run_expand(e, vv, ng, store, table), lanes.run_expand(e, vv, ng, store, table))
                launches += 1
            for kind, itemsize in (("u", 4), ("i", 1), ("f", 4)):
                key = int(lanes.order_key(v[:1, 1:2], kind, itemsize)[0, 0])
                for op in ("lt", "eq"):
                    compare(f"K19 edge tables w_pad {w_pad} T {tiles} {kind}{itemsize} {op}", "run_filter",
                            run_filter.run_filter(e, v, None, ng, kind, itemsize, op, key),
                            lanes.pack_hits(query._cmp(rle.run_expand(e, v, ng), key, op, kind, itemsize)))
                    k19 += 1
    print(f"[kernel] run_expand on edge tables (equal ends, ends of 0, all-pad tiles, runs of one, ends across a "
          f"warp's span, a padded last group) at w_pad 8..128, T 1/32/64, ng={ng}, stores 4/1 and 2 with a table: "
          f"{launches} launches bit-exact vs plain")
    print(f"[kernel] run_filter on the same tables at three kinds, lt and eq: {k19} launches bit-exact vs the "
          f"general path (K5, the compare, pack_hits)")


def scan_checks(rng, n: int) -> None:
    """delta2, xordelta and scan.group_prefix_sum."""
    ts = (np.cumsum(1000 + rng.integers(0, 4, n)) + 1_600_000_000).astype(np.int32)
    check_kernel("delta2 jittered timestamps", gtt.encode(ts, "delta2"), ts)
    walk = np.cumsum(rng.integers(-(2**24), 2**24, n)).astype(np.int32)
    col = gtt.encode(walk, "delta2")
    check(col.params["bits"] >= 25, f"delta2 walk packs to {col.params['bits']} bits, wanted >= 25")
    check_kernel(f"delta2 random walk bits={col.params['bits']}", col, walk)
    delta2_width_checks(np.random.default_rng(97))  # its own seed: the later phases' data stays as it was
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


def delta2_width_checks(rng) -> None:
    """K7 against its plain version at every B from 1 to 32 on random second
    differences, with anchors and slopes across the int32 range (its sums
    wrap mod 2^32), at every store width, on 2 * SMs + 3 groups (two blocks
    an SM, and then some)."""
    ng = 2 * torch.cuda.get_device_properties(CUDA).multi_processor_count + 3
    anchors, slopes = card_words(rng, (ng,)), card_words(rng, (ng,))
    slopes[0] = 2**31 - 1
    for bits in range(1, 33):
        packed = card_words(rng, (ng, bits * 1024))
        for store in (torch.int32, torch.int16, torch.uint8):
            compare(f"delta2 B={bits} store={store}", "delta2_decode",
                    delta2.delta2_decode(packed, anchors, slopes, bits, store),
                    lanes.delta2_decode(packed, anchors, slopes, bits, store))
    print(f"[kernel] delta2_decode at B=1..32, wrapping anchors and slopes, stores 4/2/1, ng={ng}: 96 launches "
          "bit-exact vs plain")


def patched_column(rng, n: int, dtype: str = "int32", exceptions: bool = True) -> np.ndarray:
    """4-bit values with ~1% wide exceptions, among them positions 0, n-1
    and both sides of every group boundary (none when not exceptions)."""
    v = rng.integers(0, 16, n, dtype=np.int64)
    if exceptions:
        edges = np.arange(GROUP, n, GROUP)
        idx = np.concatenate([rng.choice(n, n // 100, replace=False), [0, n - 1], edges - 1, edges])
        v[idx] = rng.integers(2**20, 2**31, idx.shape[0])
    u = v.astype(np.uint32)
    return u.view(np.dtype(dtype)) if dtype in ("int32", "float32") else u.astype(np.dtype(dtype))


def patched_checks(rng, n: int) -> None:
    """K9: both bases and kinds, narrow stores, no exceptions, n = 0."""
    v = patched_column(rng, n)
    for base in ("for", "nbit"):
        for kind in ("naive", "compressed"):
            col = gtt.encode(v, "patched", base_scheme=base, kind=kind, frame_len=2 * GROUP)
            check_kernel(f"patched {base} {kind} count={col.params['count']} bits={col.params['base_params']['bits']}",
                         col, v)
    for dtype in ("int8", "int16", "uint16", "float32"):
        vv = patched_column(rng, n, dtype)
        check_kernel(f"patched for naive {dtype}", gtt.encode(vv, "patched"), vv)
        check_kernel(f"patched nbit compressed {dtype}", gtt.encode(vv, "patched", base_scheme="nbit",
                                                                    kind="compressed"), vv)
    v = patched_column(rng, n, exceptions=False)
    for kind in ("naive", "compressed"):
        col = gtt.encode(v, "patched", kind=kind)
        check(col.params["count"] == 0, f"patched {kind} without exceptions: count {col.params['count']}")
        check_kernel(f"patched {kind} count=0", col, v)
        check_kernel(f"patched {kind} n=0", gtt.encode(v[:0], "patched", kind=kind), v[:0])


def cascade_column(rng, d: int, n: int, run: int = 50) -> tuple[np.ndarray, np.ndarray]:
    """n values of a d-entry vocabulary in runs of ``run``, and the vocabulary."""
    vocab = rng.permutation(np.arange(d, dtype=np.int64) * 65_537 - 2**31 + 3).astype(np.int32)
    return vocab[np.repeat(rng.integers(0, d, n // run + 1), run)[:n]], vocab


def cascade_checks(rng, n: int) -> None:
    """The LUT stage: every inner scheme at every dictionary mode (65536
    entries, 256 KB, is past any block's shared memory: the __ldg mode),
    both rle forms, narrow stores, n = 0."""
    for d in (1, 8, 1000, 16384, 65536):
        v, vocab = cascade_column(rng, d, n)
        for inner in INNER_SCHEMES:
            check_kernel(f"cascade {inner} d={d}", gtt.encode(v, "cascade", codes_scheme=inner, dictionary=vocab), v)
    limit = delta2.shared_lut_limit()
    print(f"[kernel] delta2_decode keeps a cascade table in shared memory up to d={limit}")
    for d in (12250, limit - 1, limit, limit + 1):  # K7's buffers take 66 KB beside the table
        v, vocab = cascade_column(rng, d, n)
        mode = "shared" if delta2.lut_in_shared(d) else "global"
        check((mode == "shared") == (d <= limit), f"cascade delta2 d={d}: {mode} table")
        check_kernel(f"cascade delta2 d={d} ({mode})", gtt.encode(v, "cascade", codes_scheme="delta2", dictionary=vocab), v)
    v, vocab = cascade_column(rng, 1000, n, run=1)
    for inner in ("rle", "rpe"):
        s = check_kernel(f"cascade {inner} d=1000 runs of 1", gtt.encode(v, "cascade", codes_scheme=inner), v)
        check("c_pos" in s, f"cascade {inner} runs of 1 did not reach the scatter form: {list(s)}")
    for dtype in ("int8", "int16", "uint16", "float32"):
        u = cascade_column(rng, 300, n)[0].view(np.uint32)
        vv = u.view(np.float32) if dtype == "float32" else u.astype(np.dtype(dtype))
        for inner in ("rle", "delta", "for"):
            check_kernel(f"cascade {inner} {dtype}", gtt.encode(vv, "cascade", codes_scheme=inner), vv)
    for inner in INNER_SCHEMES:
        col = gtt.encode(v[:0], "cascade", codes_scheme=inner, dictionary=vocab)
        check_kernel(f"cascade {inner} n=0 d={col.params['dict_size']}", col, v[:0])
        empty = gtt.encode(v[:0], "cascade", codes_scheme=inner)  # d = 0: nothing to launch
        before = kernels.launches()
        out = gtt.decode(empty, device=CUDA, pad=True)
        check(kernels.launches() == before and out.shape == (GROUP,) and not out.any(),
              f"cascade {inner} d=0 launched or gave {out}")


def model_checks(rng, n: int) -> None:
    """K10: linear, poly2 and the per-frame choice at frame_len GROUP and
    4 GROUP (p0 != 0 in the prep), 32-bit residuals, coefficients at the ends
    of the int32 range, narrow stores, n = 0."""
    v = gen_column("model", n, rng)
    for frame_len in (GROUP, 4 * GROUP):
        for kind in ("auto", "linear", "poly2"):
            col = gtt.encode(v, "model", kind=kind, frame_len=frame_len)
            check_kernel(f"model {kind} frame_len={frame_len // GROUP}G -> {col.params['kind']} "
                         f"bits={col.params['bits']}", col, v)
    hard = gen_column("model", n, rng, hard=True)
    check_kernel("model hard bits=32", gtt.encode(hard, "model", bits=32), hard)
    col = gtt.encode(v, "model", kind="poly2", frame_len=4 * GROUP)
    nf = col.streams["coef_a"].shape[0]
    col.streams.update(coef_a=np.full(nf, 2**31 - 1, np.int32), coef_b=np.full(nf, -(2**31), np.int32),
                       coef_c=np.full(nf, 2**31 - 7, np.int32))
    check_kernel("model poly2 wrapping coefficients", col, gtt.decode_ref(col))
    for dtype in ("int8", "int16", "uint16"):
        vv = v.astype(np.dtype(dtype))
        check_kernel(f"model {dtype}", gtt.encode(vv, "model"), vv)
    check_kernel("model n=0", gtt.encode(v[:0], "model"), v[:0])


def bitmap_column(rng, d: int, n: int, dtype: str = "int32") -> np.ndarray:
    """n values of d distinct random values of dtype."""
    info = np.iinfo(np.dtype(dtype))
    vocab = rng.choice(np.arange(info.min, min(info.max + 1, info.min + 2**20), dtype=np.int64), d, replace=False)
    return vocab.astype(np.dtype(dtype))[rng.integers(0, d, n)]


def bitmap_checks(rng, n: int) -> None:
    """K11 at every d (65 and 1000 are past the reference's switch to an
    XLA loop; the host packs one plane a value, so they run at 4 GROUP +
    999), uint8 values, narrow stores, two incident bits, n = 0."""
    for d, size in ((1, n), (4, n), (12, n), (64, n), (65, 4 * GROUP + 999), (1000, 4 * GROUP + 999)):
        v = bitmap_column(rng, d, size)
        check_kernel(f"bitmap d={d}", gtt.encode(v, "bitmap"), v)
    for dtype in ("uint8", "int8", "int16"):
        v = bitmap_column(rng, 12, n, dtype)
        check_kernel(f"bitmap {dtype}", gtt.encode(v, "bitmap"), v)
    v = bitmap_column(rng, 4, n)
    col = gtt.encode(v, "bitmap")
    col.streams["bitmaps"] = col.streams["bitmaps"].copy()
    col.streams["bitmaps"][1] |= col.streams["bitmaps"][0]  # value 0's positions are incident to value 1 too
    want = gtt.decode_ref(col)
    check(not np.array_equal(want, v), "bitmap two incident bits: the oracle did not sum")
    check_kernel("bitmap two incident bits (sum)", col, want)
    col = gtt.encode(v[:0], "bitmap")
    before = kernels.launches()
    out = gtt.decode(col, device=CUDA, pad=True)
    check(kernels.launches() == before and out.shape == (GROUP,) and not out.any(), f"bitmap d=0 gave {out}")
    print("[kernel] bitmap n=0 d=0: no launch, zeros")


def alp_salted(rng, n: int) -> np.ndarray:
    """Two-decimal prices salted with NaN, +-Inf, -0.0, subnormals and
    values whose v*100 lands at 2^23 - 1, 2^23 and 2^23 + 1, at random
    positions, at 0 and n-1 and on both sides of every group boundary."""
    v = np.round(rng.uniform(0, 1000, n), 2).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, (2**23 - 1) / 100, 2**23 / 100, (2**23 + 1) / 100],
                       np.float32)
    special = np.concatenate([special, np.array([1, 0x7FFFFF, 0x80000001], np.uint32).view(np.float32)])
    edges = np.arange(GROUP, n, GROUP)
    idx = np.concatenate([rng.choice(n, n // 50, replace=False), [0, n - 1], edges - 1, edges])
    v[idx] = special[rng.integers(0, special.shape[0], idx.shape[0])]
    return v


def alp_checks(rng, n: int) -> None:
    """K12: prices (no exceptions), random floats (wide corrections, some
    exceptions), the salted column at the chosen and at forced exponents
    (at e = 10 nearly every value is an exception), n = 0."""
    prices = gen_column("alp", n, rng)
    col = gtt.encode(prices, "alp")
    check(col.params["count"] == 0, f"alp prices: {col.params}")
    check_kernel(f"alp prices {col.params}", col, prices)
    hard = gen_column("alp", n, rng, hard=True)
    col = gtt.encode(hard, "alp")
    check_kernel(f"alp random floats {col.params}", col, hard)
    salted = alp_salted(rng, n)
    for e in (None, 0, 2, 10):
        col = gtt.encode(salted, "alp", e=e)
        check(col.params["count"] > n // 100, f"alp salted e={e}: {col.params}")
        check_kernel(f"alp salted {col.params}", col, salted)
    for e in (0, 10):
        col = gtt.encode(prices, "alp", e=e)
        check_kernel(f"alp prices {col.params}", col, prices)
    check_kernel("alp n=0", gtt.encode(prices[:0], "alp"), prices[:0])


def dzbv_form(streams: dict) -> str:
    """The stream form of prepped dzbv streams, with its strides or widths."""
    for prefix, what, unit in (("trow", "tile form s", 64), ("prow", "group-row form w4", 1024)):
        shape = {k: streams[f"{prefix}{k}"].shape[1] // unit for k in (1, 2, 3) if f"{prefix}{k}" in streams}
        if shape:
            return f"{what} {shape}"
    if any(f"plane{k}" in streams for k in (1, 2, 3)):
        return "on-disk planes"
    return "plane 0 only"


def dzbv_column(kind: str, n: int, rng, per_tile: int = 16) -> np.ndarray:
    """int32 values for dzbv: datagen's widths 1-4 (``mixed``), one 4-byte
    tile at the start of every group (``skewed``: the tile form declines),
    the first group all 4 bytes wide (``group_skewed``: the group-row form
    declines too), all < 256, all < 65536, 32-bit values, exactly
    ``per_tile`` 4-byte values in every 128-value tile, the rest 1 byte, or
    (``windows``) 1-byte values but the first 100 of the first group, every
    value of the groups between and all but 1100 of the last group 4 bytes
    wide."""
    if kind == "mixed":
        return gen_column("dzbv", n, rng)
    if kind == "full":
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    if kind in ("one_byte", "two_bytes"):
        return rng.integers(0, 256 if kind == "one_byte" else 65536, n).astype(np.int32)
    v = rng.integers(0, 256, n).astype(np.uint32)
    wide = rng.integers(2**24, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "skewed":
        sel = (np.arange(n) % GROUP) < 128
    elif kind == "group_skewed":
        sel = np.arange(n) < GROUP
    elif kind == "windows":
        p, last = np.arange(n), (n - 1) // GROUP * GROUP
        sel = (p < 100) | ((p >= GROUP) & (p < last)) | ((p >= max(last, GROUP)) & (p < last + GROUP - 1100))
    else:
        tiles = -(-n // 128)
        sel = np.zeros((tiles, 128), bool)
        np.put_along_axis(sel, np.argsort(rng.random((tiles, 128)), axis=1)[:, :per_tile], True, axis=1)
        sel = sel.reshape(-1)[:n]
    return np.where(sel, wide, v).view(np.int32)


def dzbv_checks(rng, n: int) -> None:
    """K13-K15: each kind of column in the prep's form and in all three,
    forced tile strides that divide 128 and that straddle its windows,
    narrow stores in every form, n = 0; then K13 and K14 at every stride
    and row width (dzbv_width_checks)."""
    for kind, picks in (("mixed", None), ("skewed", "group"), ("group_skewed", "plane"), ("one_byte", "tile"),
                        ("two_bytes", None), ("full", None)):
        v = dzbv_column(kind, n, rng)
        col = gtt.encode(v, "dzbv")
        name = kernels.kernel_call(col, check_kernel(f"dzbv {kind} (the prep's form)", col, v), torch.int32)[0]
        check(picks is None or name == DZBV_FORMS[picks], f"dzbv {kind}: the prep gave {name}, not the {picks} form")
        for form in DZBV_FORMS:
            check_kernel(f"dzbv {kind} {form}", col, v, dzbv.form_streams(col, form))
    for per_tile, strides in ((5, (8, 24, 40)), (16, (24, 56, 120)), (100, (104, 120, 128))):
        v = dzbv_column("per_tile", n, rng, per_tile)
        col = gtt.encode(v, "dzbv")
        check_kernel(f"dzbv {per_tile} wide a tile", col, v, dzbv.tile_prep(col, force_s=dict(zip((1, 2, 3), strides))))
    for dtype in ("int8", "int16", "uint16", "float32"):
        u = dzbv_column("mixed", n, rng).view(np.uint32)
        vv = u.view(np.float32) if dtype == "float32" else u.astype(np.dtype(dtype))
        col = gtt.encode(vv, "dzbv")
        for form in DZBV_FORMS:
            check_kernel(f"dzbv {dtype} {form}", col, vv, dzbv.form_streams(col, form))
    col = gtt.encode(np.zeros(0, np.int32), "dzbv")
    for form in DZBV_FORMS:
        check_kernel(f"dzbv n=0 {form}", col, np.zeros(0, np.int32), dzbv.form_streams(col, form))
    dzbv_width_checks(np.random.default_rng(89))  # its own seed: the later phases' data stays as it was
    dzbv_window_checks(np.random.default_rng(91))


def dzbv_window_checks(rng) -> None:
    """K15's windows: a column whose first group holds 100 4-byte values and
    whose other groups only 4-byte values, the last group's ranks ending in
    its stream's last row (each middle group's ranks start 100 bytes into a
    4 KB row and touch 9 rows of each of three planes: 110,592 B staged, one
    block an SM) over 2 * SMs + 3 groups; then random widths and plane 0
    over plane streams far too short for them (ranks clamp to the stream's
    last byte), with a plane absent, at every store width."""
    sms = torch.cuda.get_device_properties(CUDA).multi_processor_count
    n = (2 * sms + 3) * GROUP
    v = dzbv_column("windows", n, rng)
    col = gtt.encode(v, "dzbv")
    check_kernel(f"dzbv windows ng={n // GROUP}", col, v, col.streams)
    ng = 5
    widths, plane0 = card_words(rng, (ng, 2048)), card_words(rng, (ng, 8192))
    for rows in ((1, 2, 3), (2, None, 1), (None, None, 4), (8, 6, 4)):
        planes = tuple(None if a is None else card_words(rng, (a, 8192)) for a in rows)
        for store in (torch.int32, torch.int16, torch.uint8):
            compare(f"dzbv random plane rows {rows} store={store}", "dzbv_plane_decode",
                    dzbv.dzbv_plane_decode(widths, plane0, planes, store),
                    lanes.dzbv_plane_decode(widths, plane0, planes, store))
    print(f"[kernel] dzbv_plane_decode on random widths over short plane streams, planes absent, stores 4/2/1: "
          "12 launches bit-exact vs plain")


def dzbv_width_checks(rng) -> None:
    """K13 at every stride s = 8..128 and K14 at every row width w4 = 1..8,
    with planes {1}, {1, 2} and {1, 2, 3}, against their plain versions bit
    for bit, on one group and on 2 * SMs + 3 (two blocks an SM, and then
    some): width codes with exactly s (K13) or 16 * w4 (K14) of the widest
    values in every tile, so every tile's row slot (K13) or group's row
    (K14) is full, random plane 0 and random rows."""
    sms = torch.cuda.get_device_properties(CUDA).multi_processor_count
    launches = 0
    for ng in (1, 2 * sms + 3):
        # a random order of each tile's values: its first `per` are the wide ones
        order = np.argsort(np.argsort(rng.random((ng * GROUP // 128, 128)), axis=1), axis=1)
        order = torch.from_numpy(order.reshape(ng, GROUP).astype(np.int32)).to(CUDA)
        plane0 = card_words(rng, (ng, 8 * 1024))
        for form, shapes, unit in (("tile", range(8, 129, 8), 64), ("group", range(1, 9), 1024)):
            name = DZBV_FORMS[form]
            for a in shapes:
                wide = (order < (a if form == "tile" else 16 * a)).to(torch.int32)
                for planes in (1, 2, 3):
                    widths = lanes.pack_lanes(wide * planes, 2)
                    rows = tuple(card_words(rng, (ng, unit * a)) if k < planes else None for k in range(3))
                    compare(f"dzbv {form} {'s' if form == 'tile' else 'w4'}={a} planes 1..{planes} ng={ng}", name,
                            getattr(dzbv, name)(widths, plane0, rows), getattr(lanes, name)(widths, plane0, rows))
                    launches += 1
    print(f"[kernel] dzbv_tile_decode at s=8..128 and dzbv_group_decode at w4=1..8, planes {{1}}, {{1, 2}}, {{1, 2, 3}}, "
          f"ng=1 and {2 * sms + 3}, rows full: {launches} launches bit-exact vs plain")


SCAN_DTYPES = ("int32", "uint32", "float32", "int8", "int16", "uint8", "uint16")
FLOAT_SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)


def scan_column(rng, dtype: str, n: int) -> np.ndarray:
    """n values of dtype for the scan layer: integers over the whole range
    with both ends and 0 salted in; floats of many magnitudes and both signs
    with NaN, -NaN, +-Inf, -0.0 and 0.0 salted in, also on both sides of
    every group boundary."""
    if dtype == "float32":
        v = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 6, n)).astype(np.float32)
        edges = np.arange(GROUP, n, GROUP)
        idx = np.concatenate([rng.choice(n, n // 100, replace=False), edges - 1, edges])
        v[idx] = FLOAT_SPECIALS[rng.integers(0, FLOAT_SPECIALS.shape[0], idx.shape[0])]
        return v
    info = np.iinfo(np.dtype(dtype))
    v = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True)
    v[rng.choice(n, 64, replace=False)] = rng.choice([info.min, info.max, 0], 64)
    return v.astype(np.dtype(dtype))


def thresholds(dtype: str, v: np.ndarray) -> list:
    """Comparison values: one of the column's, the dtype's ends and one past
    them (the mod-2^32 staging), 2^32 + 5; for floats +-0.0, +-Inf and NaN."""
    if dtype == "float32":
        return [float(v[len(v) // 2]), 0.0, -0.0, np.inf, -np.inf, np.nan]
    info = np.iinfo(np.dtype(dtype))
    return [int(v[len(v) // 2]), int(info.min), int(info.max), int(info.max) + 1, 2**32 + 5]


def scan_keys(v: np.ndarray) -> np.ndarray:
    """The NumPy oracle's order: integers as int64, float32 in IEEE total
    order (-NaN < -Inf < ... < -0.0 < +0.0 < ... < +Inf < +NaN)."""
    if v.dtype.kind != "f":
        return v.astype(np.int64)
    b = v.view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF) - 1, b)


def oracle_mask(v: np.ndarray, op: str, value, valid: np.ndarray | None = None) -> np.ndarray:
    """The predicate on each value in the column's logical dtype, the value
    staged as the scan stages it (floats as float32, integers mod 2^32 into
    int32 or uint32); False at null rows."""
    if v.dtype.kind == "f":
        c = int(scan_keys(np.array([value], np.float32))[0])
    else:
        c = int(value) % 2**32
        c = c - 2**32 if v.dtype.kind == "i" and c >= 2**31 else c
    k = scan_keys(v)
    hit = {"eq": k == c, "ne": k != c, "lt": k < c, "le": k <= c, "gt": k > c, "ge": k >= c}[op]
    return hit if valid is None else hit & valid


def oracle_agg(v: np.ndarray, name: str, valid: np.ndarray | None = None):
    """sum (exact int; float64 in NumPy's order for floats), min or max (total
    order for floats) of the non-null values."""
    v = v if valid is None else v[valid]
    if name == "sum":
        return float(np.sum(v, dtype=np.float64)) if v.dtype.kind == "f" else int(v.astype(np.int64).sum())
    k = scan_keys(v)
    return v[int(np.argmax(k) if name == "max" else np.argmin(k))].item()


def same_value(a, b) -> bool:
    """Equal aggregates; floats by their float32 bits, so NaN equals NaN."""
    if isinstance(a, float) or isinstance(b, float):
        return np.float32(a).view(np.uint32) == np.float32(b).view(np.uint32)
    return a == b


def scan_args(col) -> tuple:
    """(packed, refs_g, bits, kind, itemsize) of a fused column on the card."""
    streams = gtt.device_streams(col, CUDA)
    dt = np.dtype(col.dtype)
    bits = col.params["bits"] if col.scheme != "dzbf" else 8 * col.params["width"]
    return streams["packed"], streams.get("refs_g"), bits, dt.kind, dt.itemsize


def check_scan_kernels(label: str, col, v: np.ndarray, valid: np.ndarray | None = None) -> None:
    """K16 at every op and threshold and K17 for sum, min and max against
    their plain versions on the card (bit-exact, pad bits included), K16's
    bits against the NumPy oracle's predicate, and count_where, sum_, min_
    and max_ against the oracle."""
    packed, refs_g, bits, kind, itemsize = scan_args(col)
    vw = nulls.valid_words_device(col, CUDA) if valid is not None else None
    for op in OPS:
        for value in thresholds(col.dtype, v) if col.n else [0]:
            key = query._stage_key(col.dtype, value)
            got = filter_.filter_fold(packed, refs_g, vw, bits, kind, itemsize, op, key)
            compare(f"{label} {op} {value}", "filter_fold", got, lanes.filter_fold(packed, refs_g, vw, bits, kind,
                                                                                   itemsize, op, key))
            want = oracle_mask(v, op, value, valid)
            hits = lanes.unpack_lanes(got, 1).reshape(-1)[: col.n].bool()
            check(torch.equal(hits, torch.from_numpy(want).to(CUDA)), f"{label} {op} {value}: filter_fold != oracle")
            check(query.count_where(col, op, value, device=CUDA) == int(want.sum()),
                  f"{label} {op} {value}: count_where != oracle")
    carries = 0
    for name in ("sum", "min", "max"):
        w = vw if name == "sum" else None
        got = agg.agg_fold(packed, refs_g, w, bits, col.n, kind, itemsize, name)
        compare(f"{label} {name}", "agg_fold", got, lanes.agg_fold(packed, refs_g, w, bits, col.n, kind, itemsize, name))
        if name == "sum":
            carries = int((got[1] != 0).sum())
        if col.n == 0:
            check(aggregate.sum_(col, device=CUDA) == 0, f"{label}: sum_ of nothing")
            continue
        got_value = getattr(aggregate, f"{name}_")(col, device=CUDA)
        check(same_value(got_value, oracle_agg(v, name, valid)), f"{label}: {name}_ {got_value} != oracle")
    print(f"[kernel] {label}: filter_fold x {6 * len(thresholds(col.dtype, v)) if col.n else 6}, agg_fold sum/min/max "
          f"(lanes whose sum carried past 32 bits: {carries}) n={col.n} bits={bits} bit-exact vs plain and oracle")


def card_words(rng, shape: tuple) -> torch.Tensor:
    """Random uint32 words as int32 on the card."""
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(CUDA)


def fold_width_checks(rng) -> None:
    """K16 and K17 against their plain versions at every B from 1 to 32, on
    random packed words: one group, and more tiles than the persistent grid
    has blocks (not a multiple of it); n = ng * GROUP - 5; with and without
    FOR refs and validity words; K16 at each kind with lt against a random
    key and eq against the first value, K17 sum, min and max."""
    sms = torch.cuda.get_device_properties(CUDA).multi_processor_count
    launches = 0
    for bits in range(1, 33):
        for ng in (1, sms + 3):
            n = ng * GROUP - 5
            packed = card_words(rng, (ng, bits * 1024))
            first = lanes.lmp_unpack(packed[:1], bits).reshape(-1)[:1]
            for refs_g in (None, card_words(rng, (ng,))):
                u0 = first if refs_g is None else lanes.wrap32(first.to(torch.int64) + refs_g[:1])
                for vw in (None, card_words(rng, (ng, 1024))):
                    label = f"fold B={bits} ng={ng} refs={refs_g is not None} valid={vw is not None}"
                    for kind, itemsize in (("u", 4), ("i", 2), ("f", 4)):
                        keys = {"lt": int(rng.integers(-(2**31), 2**31)),
                                "eq": int(lanes.order_key(u0, kind, itemsize)[0])}
                        for op, key in keys.items():
                            compare(f"{label} {kind} {op}", "filter_fold",
                                    filter_.filter_fold(packed, refs_g, vw, bits, kind, itemsize, op, key),
                                    lanes.filter_fold(packed, refs_g, vw, bits, kind, itemsize, op, key))
                        for name in ("sum", "min", "max"):
                            w = vw if name == "sum" else None
                            compare(f"{label} {kind} {name}", "agg_fold",
                                    agg.agg_fold(packed, refs_g, w, bits, n, kind, itemsize, name),
                                    lanes.agg_fold(packed, refs_g, w, bits, n, kind, itemsize, name))
                        launches += 5
    print(f"[kernel] filter_fold and agg_fold at B=1..32, ng=1 and {sms + 3} (n = ng*GROUP-5), with and without "
          f"refs and validity words: {launches} launches bit-exact vs plain")


def scan_layer_checks(rng, n: int) -> None:
    """K16 and K17: nbit, dzbf and for at every logical dtype (narrow
    payloads sign-extend), all six ops at the dtype's edges and past them,
    floats with NaN, +-Inf and -0.0 through nbit at 32 bits, full-range
    values (sums carry past 32 bits), nullable columns, n = 0; then every
    width on random words (fold_width_checks)."""
    for scheme in ("nbit", "dzbf", "for"):
        for dtype in SCAN_DTYPES:
            v = scan_column(rng, dtype, n)
            col = gtt.encode(v, scheme)
            if scheme == "nbit" and dtype == "float32":
                check(col.params["bits"] == 32, f"float32 nbit packs to {col.params}")
            check_scan_kernels(f"scan {scheme} {dtype}", col, v)
        v = scan_column(rng, "int32", n)
        valid = rng.random(n) > 0.1
        check_scan_kernels(f"scan {scheme} int32 10% nulls", gtt.encode(v, scheme, valid=valid), v, valid)
        empty = gtt.encode(v[:0], scheme)
        before = kernels.launches()
        check(query.count_where(empty, "lt", 0, device=CUDA) == 0 and kernels.launches() == before,
              f"{scheme} n=0: count_where launched or counted")
        check_scan_kernels(f"scan {scheme} n=0", empty, v[:0])
    fold_width_checks(np.random.default_rng(88))  # its own seed: the later phases' data stays as it was


def same_column(got, want) -> bool:
    """Two EncodedColumns alike: name, scheme, dtype, n, params, and every
    stream's dtype, shape and bytes."""
    return ((got.name, got.scheme, got.dtype, got.n, got.params) == (want.name, want.scheme, want.dtype, want.n,
                                                                    want.params)
            and sorted(got.streams) == sorted(want.streams)
            and all(got.streams[k].dtype == w.dtype and same_bits(got.streams[k], w) for k, w in want.streams.items()))


def to_card(a: np.ndarray) -> torch.Tensor:
    """A 1-D array of 4-byte payloads as an int32 tensor on the card."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(CUDA)


def frame_pad(v: np.ndarray, frame_len: int) -> np.ndarray:
    """A 4-byte column's payloads padded to whole frames with the last
    value, as the host FOR encoder pads (ref/for_.py): for_streams_device's
    input."""
    u = v.view(np.uint32)
    nf = -(-num_groups(u.shape[0]) * GROUP // frame_len)
    out = np.full(nf * frame_len, u[-1] if u.shape[0] else 0, np.uint32)
    out[: u.shape[0]] = u
    return out


def pack_check(label: str, u: np.ndarray, bits: int, want: np.ndarray, prologue: str = "none",
               refs: np.ndarray | None = None, n: int | None = None, frame_len: int = GROUP) -> None:
    """K18 on the payloads u (whole groups) against its plain version on
    the card and against ref.lmp.lmp_pack of ``want``, the payloads after
    the prologue computed in NumPy, bit for bit."""
    args = (to_card(u).view(-1, GROUP), bits, prologue, None if refs is None else to_card(refs), n, frame_len)
    got = encode.lmp_pack(*args)
    compare(label, "lmp_pack", got, lanes.lmp_pack(*args))
    check(same_bits(got.cpu().numpy().view(np.uint32), ref_lmp.lmp_pack(want, bits)), f"{label}: != ref.lmp.lmp_pack")


def for_values(rng, n: int) -> np.ndarray:
    """int32 values within 2048 of the sign boundary on both sides: their
    unsigned frame min is not the signed one."""
    return (2**31 - 2048 + rng.integers(0, 4096, n)).astype(np.uint32).view(np.int32)


def wrapping_walk(rng, n: int) -> np.ndarray:
    """An int32 walk whose steps span all of int32: it wraps both ways."""
    return np.cumsum(rng.integers(-(2**31), 2**31, n, dtype=np.int64)).astype(np.uint32).view(np.int32)


def pack_checks(rng, n: int) -> None:
    """K18 at every width with no prologue, the FOR subtract at frame_len
    GROUP and 2 GROUP, the delta zigzag on a walk that crosses the int32
    wrap and on small steps, each at n, 1 and 0 values."""
    for bits in range(1, 33):
        u = pad_to_groups(rng.integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32))
        pack_check(f"lmp_pack B={bits}", u, bits, u)
    for size in (n, 1, 0):
        for frame_len in (GROUP, 2 * GROUP):
            u = frame_pad(for_values(rng, size), frame_len)
            refs = u.reshape(-1, frame_len).min(axis=1)
            offs = u - np.repeat(refs, frame_len)
            bits = max(1, int(offs.max()).bit_length())
            pack_check(f"lmp_pack for_sub frame_len={frame_len // GROUP}G n={size} B={bits}", u, bits, offs,
                       "for_sub", refs, frame_len=frame_len)
        for name, v in (("wrapping walk", wrapping_walk(rng, size)),
                        ("timestamps", (np.cumsum(rng.integers(0, 8, size)) + 1_600_000_000).astype(np.int32))):
            u = pad_to_groups(v.view(np.uint32))
            d = np.zeros(u.shape[0], np.int32)
            d[1:size] = np.diff(v.view(np.uint32)).view(np.int32)
            z = zigzag(d)
            bits = max(1, int(z.max()).bit_length())
            pack_check(f"lmp_pack delta_zigzag {name} n={size} B={bits}", u, bits, z, "delta_zigzag", n=size)
    print(f"[kernel] lmp_pack: B = 1..32, for_sub at frame_len 1G and 2G, delta_zigzag on a wrapping walk and "
          f"timestamps, n = {n}, 1, 0: bit-exact vs plain and ref.lmp.lmp_pack")


def encoder_checks(rng, n: int) -> None:
    """Each device encoder against the host encoder (the same column, byte
    for byte) at n, 1 and 0 values, and each device-encoded column decoded
    on the card back to its input: nbit at five dtypes, FOR at frame_len
    GROUP and 2 GROUP (the device packs every group of the frame-padded
    values; the host's rows are the first), delta on a wrapping walk, dict
    with negative, >= 2^31, float (-0.0, NaN) and 65536-entry vocabularies,
    rle from runs of 100-5000 down to runs of 1."""
    for size in (n, 1, 0):
        for dtype in ("int8", "int16", "uint16", "int32", "float32"):
            dt = np.dtype(dtype)
            v = rng.integers(0, 2 ** (8 * dt.itemsize), size, dtype=np.uint64).astype(f"uint{8 * dt.itemsize}").view(dt)
            encoder_check(f"encode_nbit_device {dtype} n={size}", v, encode.encode_nbit_device(v, bits=8 * dt.itemsize),
                          gtt.encode(v, "nbit", bits=8 * dt.itemsize))
        v = for_values(rng, size)
        for frame_len in (GROUP, 2 * GROUP):
            host = gtt.encode(v, "for", frame_len=frame_len)
            packed, refs = encode.for_streams_device(to_card(frame_pad(v, frame_len)), host.params["bits"], frame_len)
            ng = host.streams["packed"].shape[0]
            col = dataclasses.replace(host, streams={"packed": packed[:ng].cpu().numpy().view(np.uint32),
                                                     "refs": refs.cpu().numpy()})
            encoder_check(f"for_streams_device frame_len={frame_len // GROUP}G n={size} ({packed.shape[0]} rows)",
                          v, col, host)
        v = wrapping_walk(rng, size)
        host = gtt.encode(v, "delta")
        packed, anchors = encode.delta_streams_device(to_card(pad_to_groups(v.view(np.uint32))), host.params["bits"],
                                                      n=size)
        col = dataclasses.replace(host, streams={"packed": packed.cpu().numpy().view(np.uint32),
                                                 "anchors": anchors.cpu().numpy()})
        encoder_check(f"delta_streams_device wrapping walk n={size}", v, col, host)
        vocab = np.arange(65536, dtype=np.int64) * 65_537 - 2**31 + 99
        for label, v in (("negative", np.array([-(2**31), 2**31 - 1, -1, 0, -70, 55], np.int32)),
                         ("u32 >= 2^31", np.array([0, 2**31 - 1, 2**31, 2**32 - 1, 3_000_000_000], np.uint32)),
                         ("float32", np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -2.25], np.float32)),
                         ("int8", np.array([-128, 127, -1, 0, 5], np.int8)),
                         ("d=65536", vocab.astype(np.int32))):
            v = v[rng.integers(0, v.shape[0], size)]
            encoder_check(f"encode_dict_device {label} n={size}", v, encode.encode_dict_device(v), gtt.encode(v, "dict"))
        for label, v in (("runs 100-5000", run_column(rng, size, 100, 5000)), ("runs 1-8", run_column(rng, size, 1, 8)),
                         ("runs of 1", np.arange(size, dtype=np.int32)), ("one run", np.full(size, -7, np.int32))):
            encoder_check(f"encode_rle_device {label} n={size}", v, encode.encode_rle_device(v), gtt.encode(v, "rle"))
    print("[kernel] device encoders: every column byte-identical to the host encoder's and decoded to its input")


def encoder_check(label: str, v: np.ndarray, col, host) -> None:
    check(same_column(col, host), f"{label}: device-encoded column != the host encoder's")
    check(same_on_card(gtt.decode(col, device=CUDA), v), f"{label}: decode of the device-encoded column != input")


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
    patched_checks(rng, n)
    cascade_checks(rng, n)
    model_checks(rng, n)
    bitmap_checks(rng, n)
    alp_checks(rng, n)
    dzbv_checks(rng, n)
    scan_layer_checks(rng, n)
    pack_checks(rng, n)
    encoder_checks(rng, n)
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


def main_columns(v0: np.ndarray) -> list:
    """BASELINE.json configs[0]-[3] at the sizes of tests/test_scale.py
    (configs[0]'s values ``v0``), the configs[1] timestamps as delta2 too,
    and a slowly varying float32 series as xordelta: (label, input values,
    encoded column), host-encoded and timed here."""
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
        cols.append((label, v, encoded(label, v, scheme, **opts)))
    return cols


def epilogue_columns() -> list:
    """The model, bitmap and alp columns: datagen's curved ramps (they
    encode as poly2), d = 4 codes and two-decimal prices, 2^26 values each,
    seeds 10, 11 and 12: (label, input values, encoded column)."""
    cols = []
    for label, scheme, seed in [("model poly2 n=2^26", "model", 10), ("bitmap d=4 n=2^26", "bitmap", 11),
                                ("alp prices n=2^26", "alp", 12)]:
        v = gen_column(scheme, 2**26, np.random.default_rng(seed))
        cols.append((label, v, encoded(label, v, scheme)))
    check(cols[0][2].params["kind"] == "poly2" and cols[1][2].params["d"] == 4, "model/bitmap main columns")
    return cols


HOST_ENCODE_S: dict[str, float] = {}  # label -> seconds of its host encode


def encoded(label: str, v: np.ndarray, scheme: str, **opts):
    t0 = time.perf_counter()
    col = gtt.encode(v, scheme, name=label, **opts)
    HOST_ENCODE_S[label] = time.perf_counter() - t0
    ratio = (f"{col.nbytes_compressed} B of streams, codes {col.params['codes_scheme']}" if scheme == "strdict"
             else f"{col.nbytes_decoded / col.nbytes_compressed:.2f}x")
    print(f"[encode] {label}: host encode {HOST_ENCODE_S[label]:.2f} s ({ratio}), params {col.params}")
    return col


def container_columns() -> list:
    """BASELINE.json configs[4] as bench.py's bench_mixed builds it
    (bench.py:118-121): datagen.gen_column for delta, dict, rle and patched
    in that order from one default_rng(0), default options, at 2^26 values
    a column (1 GiB decoded in all): (input values, encoded column)."""
    rng = np.random.default_rng(0)
    out = []
    for s in ("delta", "dict", "rle", "patched"):
        v = gen_column(s, 2**26, rng)
        out.append((v, encoded(f"mix_{s}", v, s)))
    return out


def cascade_main() -> tuple[np.ndarray, object]:
    """The RLE_DICTIONARY column: datagen's cascade data (d = 8, runs of
    50-2000), 2^26 values, seed 6, encoded cascade over the default rle."""
    v = gen_column("cascade", 2**26, np.random.default_rng(6))
    return v, encoded("cascade rle d=8 n=2^26", v, "cascade")


def dzbv_main(v: np.ndarray) -> tuple[np.ndarray, object]:
    """The dzbv column (dzbv_values), encoded."""
    return v, encoded("dzbv n=2^26", v, "dzbv")


def scan_input() -> torch.Tensor:
    """The input of the group_prefix_sum path: 2^26 random int32."""
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.integers(-(2**31), 2**31, 2**26, dtype=np.int64).astype(np.int32))


def scan_columns(cols: list) -> dict:
    """The scan layer's main-path columns, by role: configs[0] (nbit), the
    configs[1] timestamps as for and as delta, the same for column with 1%
    nulls (encoded through encode(..., valid=mask)), configs[2] (dict) and
    configs[3] (rle), each as (input values, validity or None, encoded
    column)."""
    by_label = {label: (v, col) for label, v, col in cols}
    ts, for_col = by_label["configs[1] for n=2^26"]
    valid = np.random.default_rng(8).random(ts.shape[0]) >= 0.01
    t0 = time.perf_counter()
    nullable = gtt.encode(ts, "for", valid=valid, name="configs[1] for 1% nulls")
    print(f"[encode] configs[1] for n=2^26 with 1% nulls: host fill + encode {time.perf_counter() - t0:.2f} s, "
          f"{nulls.null_count(nullable)} nulls")
    v0, c0 = by_label["configs[0] nbit 9-bit n=2^28"]
    v2, c2 = by_label["configs[2] dict d=1000 n=2^26"]
    v3, c3 = by_label["configs[3] rle n=2^26"]
    return {
        "configs[0] nbit": (v0, None, c0),
        "configs[1] for": (ts, None, for_col),
        "configs[1] for 1% nulls": (ts, valid, nullable),
        "configs[2] dict": (v2, None, c2),
        "configs[1] delta": (ts, None, by_label["configs[1] delta n=2^26"][1]),
        "configs[3] rle": (v3, None, c3),
    }


def same_on_card(out: torch.Tensor, v: np.ndarray) -> bool:
    """Bit-equal to the host array v (floats compared as bits)."""
    return out.shape == v.shape and torch.equal(out.view(torch.uint8), torch.from_numpy(v.view(np.uint8)).to(CUDA))


def main_path(cols: list, x: torch.Tensor, container: list, casc: tuple, rank: tuple, epilogue: list,
              dz: tuple, scan: dict, analytic: tuple, tables: Tables,
              smi: str) -> tuple[dict[str, int], dict[str, int], str]:
    """Phase 4: each main path -- every column through decode(col,
    device=cuda), scan.group_prefix_sum(x), the configs[4] container
    through decode_columns(cols, device=cuda), the cascade column and K5's
    _rank_call cell through decode, the model, bitmap and alp columns through decode_columns
    together, the dzbv column through decode (the prep's form), in the two
    other forms (the tile and group-row forms through decode of the column
    with those streams, the on-disk planes through its decoder on the
    uploaded streams) and beside configs[4] through decode_columns, and the
    scan layer's entry points on the ``scan`` columns (scan_main_path) --
    with the launch counts set to 0 just before it and read just after, and
    its output checked against its input (the prefix sum against the plain
    version on the host). Returns the counts summed over the paths, K5's
    counts by form (kernels.form_launches) summed likewise, and the dzbv
    column's prep's form."""
    totals = dict.fromkeys(KERNELS, 0)
    forms = dict.fromkeys(kernels.form_launches(), 0)

    def drive(label: str, what: str, fn, expect: tuple = ()) -> dict[str, int]:
        kernels.reset_launches()
        ok = fn()
        torch.cuda.synchronize()
        launched = {k: c for k, c in kernels.launches().items() if c}
        by_form = kernels.form_launches()
        check(ok, f"{label}: {what} is wrong")
        check(bool(launched), f"{label}: no kernel launched")
        check(all(launched.get(k) for k in expect), f"{label}: {expect} not all launched: {launched}")
        check(sum(by_form.values()) == launched.get("run_expand", 0), f"{label}: K5 forms {by_form} vs {launched}")
        for k, c in launched.items():
            totals[k] += c
        for k, c in by_form.items():
            forms[k] += c
        k5 = f"; K5 by form {by_form}" if launched.get("run_expand") else ""
        print(f"[main] {label}: {what} bit-exact; launches {launched}{k5}")
        return launched

    for label, v, col in cols:
        drive(label, "decode(col, device=cuda) vs input",
              lambda: same_on_card(gtt.decode(col, device=CUDA), v))
    want = gtt.scan.group_prefix_sum(x).view(torch.int32)
    for exclusive in (False, True):
        want_x = want - x if exclusive else want
        drive(f"group_prefix_sum n=2^26 exclusive={exclusive}", "scan.group_prefix_sum(x on cuda) vs plain version",
              lambda: torch.equal(gtt.scan.group_prefix_sum(x.to(CUDA), exclusive=exclusive).view(torch.int32),
                                  want_x.to(CUDA)))

    def container_ok(pairs: list) -> bool:
        outs = gtt.decode_columns([col for _, col in pairs], device=CUDA)
        return sorted(outs) == sorted(col.name for _, col in pairs) and all(
            same_on_card(outs[col.name], v) for v, col in pairs)

    drive("configs[4] mixed container 4 x 2^26", "decode_columns(cols, device=cuda) vs inputs",
          lambda: container_ok(container))
    v, col = casc
    drive("cascade rle d=8 n=2^26", "decode(col, device=cuda) vs input", lambda: same_on_card(gtt.decode(col, device=CUDA), v))
    v, col = rank
    drive(col.name, "decode(col, device=cuda) vs input", lambda: same_on_card(gtt.decode(col, device=CUDA), v),
          expect=("run_expand",))
    check(kernels.form_launches()["rank"] >= 1, f"{col.name}: K5 did not take its rank form")
    drive("model + bitmap + alp 3 x 2^26", "decode_columns(cols, device=cuda) vs inputs",
          lambda: container_ok(epilogue))
    v, col = dz
    launched = drive("dzbv n=2^26, the prep's form", "decode(col, device=cuda) vs input",
                     lambda: same_on_card(gtt.decode(col, device=CUDA), v))
    picked = next(form for form, name in DZBV_FORMS.items() if launched.get(name))
    for form in DZBV_FORMS:
        if form == "plane" and picked != "plane":
            drive("dzbv n=2^26, on-disk planes", "get_decoder(col)(uploaded col.streams) vs input",
                  lambda: same_on_card(gtt.get_decoder(col)(gtt.upload(col.streams, CUDA))[: col.n], v))
        elif form != picked:
            drive(f"dzbv n=2^26, {form} form", f"decode(col with form_streams(col, {form!r}), device=cuda) vs input",
                  lambda: same_on_card(gtt.decode(dataclasses.replace(col, streams=dzbv.form_streams(col, form)),
                                                  device=CUDA), v))
    drive("configs[4] + dzbv 5 x 2^26", "decode_columns(cols, device=cuda) vs inputs",
          lambda: container_ok(container + [dz]))
    scan_main_path(scan, drive)
    encode_main_path({label: (v, col) for label, v, col in cols}, drive)
    analytic_main_path(*analytic, drive)
    tables_main_path(tables, drive)
    dist_main_path(tables, container, drive)
    examples_main_path(drive, smi)
    bench_main_path(drive)
    return totals, forms, picked


def scan_main_path(scan: dict, drive) -> None:
    """The scan layer's main paths: count_where and filter_bitmap on
    configs[0] at every op (K16); sum_, min_, max_ and avg_ on configs[0],
    on configs[1] as for (K17, with refs) and on that column with 1% nulls
    (K17 with validity words for the sum), and its count_where (K16 with
    them); count_where on configs[2] through the dict-domain pushdown (K16
    over the codes) and its sum_ through the code counts (K1); count_where
    on configs[1] as delta (K3, then the compare in torch ops);
    count_between on configs[3] as rle (K19 on its run tables, twice). Each
    held against NumPy on the input."""
    v, _, col = scan["configs[0] nbit"]
    value = 256
    for op in OPS:
        want = int(oracle_mask(v, op, value).sum())
        drive(f"configs[0] count_where {op} {value}", "query.count_where(col, device=cuda) vs NumPy",
              lambda: query.count_where(col, op, value, device=CUDA) == want, ("filter_fold",))
    host = torch.from_numpy(v).to(CUDA)
    want_words = lanes.pack_hits((host < value).view(-1, GROUP))  # 2^28: whole groups, no pad bits
    del host
    drive(f"configs[0] filter_bitmap lt {value}", "query.filter_bitmap(col, device=cuda) vs the input's compare",
          lambda: torch.equal(query.filter_bitmap(col, "lt", value, device=CUDA), want_words), ("filter_fold",))
    del want_words
    for key in ("configs[0] nbit", "configs[1] for", "configs[1] for 1% nulls"):
        v, valid, col = scan[key]
        nv = v.shape[0] if valid is None else int(valid.sum())
        for name in ("sum", "min", "max", "avg"):
            want = float(oracle_agg(v, "sum", valid)) / nv if name == "avg" else oracle_agg(v, name, valid)
            drive(f"{key} {name}_", f"aggregate.{name}_(col, device=cuda) vs NumPy",
                  lambda: getattr(aggregate, f"{name}_")(col, device=CUDA) == want, ("agg_fold",))
    v, valid, col = scan["configs[1] for 1% nulls"]
    value = int(v[v.shape[0] // 2])
    want = int(oracle_mask(v, "lt", value, valid).sum())
    drive("configs[1] for 1% nulls count_where lt", "query.count_where(col, device=cuda) vs NumPy",
          lambda: query.count_where(col, "lt", value, device=CUDA) == want, ("filter_fold",))
    v, _, col = scan["configs[2] dict"]
    want = int(oracle_mask(v, "lt", 0).sum())
    drive("configs[2] dict count_where lt 0 (dict-domain pushdown)", "query.count_where(col, device=cuda) vs NumPy",
          lambda: query.count_where(col, "lt", 0, device=CUDA) == want, ("filter_fold",))
    want = oracle_agg(v, "sum")
    drive("configs[2] dict sum_ (code counts)", "aggregate.sum_(col, device=cuda) vs NumPy",
          lambda: aggregate.sum_(col, device=CUDA) == want, ("lmp_unpack",))
    v, _, col = scan["configs[1] delta"]
    value = int(v[v.shape[0] // 3])
    want = int(oracle_mask(v, "ge", value).sum())
    drive("configs[1] delta count_where ge (general path)", "query.count_where(col, device=cuda) vs NumPy",
          lambda: query.count_where(col, "ge", value, device=CUDA) == want, ("delta_decode",))
    v, _, col = scan["configs[3] rle"]
    want = int(((v >= 1) & (v <= 3)).sum())
    drive("configs[3] rle count_between 1 3 (run tables)", "query.count_between(col, device=cuda) vs NumPy",
          lambda: query.count_between(col, 1, 3, device=CUDA) == want, ("run_filter",))


ENCODE_CELLS = {
    "nbit": "configs[0] nbit 9-bit n=2^28", "delta": "configs[1] delta n=2^26", "for": "configs[1] for n=2^26",
    "dict": "configs[2] dict d=1000 n=2^26", "rle": "configs[3] rle n=2^26",
}


def device_encoders(by_label: dict) -> dict:
    """For each device encoder, (label, input values, host-encoded column,
    fn): fn() device-encodes the input end to end -- host pad, H2D, the
    device work, D2H of the streams -- into a column like the host one
    (delta and FOR through their stream functions, at the host column's
    bits and frame_len)."""
    out = {}
    for scheme, label in ENCODE_CELLS.items():
        v, host = by_label[label]
        if scheme == "nbit":
            fn = lambda v=v, host=host: encode.encode_nbit_device(v, bits=host.params["bits"], name=host.name)  # noqa: E731
        elif scheme == "delta":
            def fn(v=v, host=host):
                packed, anchors = encode.delta_streams_device(to_card(pad_to_groups(v.view(np.uint32))),
                                                              host.params["bits"], n=v.shape[0])
                return dataclasses.replace(host, streams={"packed": packed.cpu().numpy().view(np.uint32),
                                                          "anchors": anchors.cpu().numpy()})
        elif scheme == "for":
            def fn(v=v, host=host):
                packed, refs = encode.for_streams_device(to_card(frame_pad(v, host.params["frame_len"])),
                                                         host.params["bits"], host.params["frame_len"])
                ng = host.streams["packed"].shape[0]
                return dataclasses.replace(host, streams={"packed": packed[:ng].cpu().numpy().view(np.uint32),
                                                          "refs": refs.cpu().numpy()})
        elif scheme == "dict":
            fn = lambda v=v, host=host: encode.encode_dict_device(v, name=host.name)  # noqa: E731
        else:
            fn = lambda v=v, host=host: encode.encode_rle_device(v, name=host.name)  # noqa: E731
        out[scheme] = (label, v, host, fn)
    return out


def encode_main_path(by_label: dict, drive) -> None:
    """Device encode of the configs[0]-[3] columns (ENCODE_CELLS), each
    column held byte for byte to the host encoder's; K18 packs all but
    rle's, whose run tables are torch ops only, so its column is also
    decoded on the card and held to the input."""
    for scheme, (label, v, host, fn) in device_encoders(by_label).items():
        if scheme == "rle":
            def rle_ok(fn=fn, host=host, v=v) -> bool:
                col = fn()
                return same_column(col, host) and same_on_card(gtt.decode(col, device=CUDA), v)

            drive(f"{label} encode_rle_device", "the host encoder's column, then decode(col, device=cuda) vs input",
                  rle_ok)
        else:
            drive(f"{label} device encode", "the host encoder's column", lambda: same_column(fn(), host), ("lmp_pack",))


def resident_decoders(container: list) -> tuple[list, list]:
    """The container's cached decoders and its streams, uploaded."""
    cols = [col for _, col in container]
    streams = [gtt.device_streams(col, CUDA) for col in cols]
    return [gtt.get_decoder(col, gtt.narrow_store_dtype(col)) for col in cols], streams


def container_without_sync(label: str, container: list) -> None:
    """Phase 4: the container's decoders, back to back on resident streams
    under sync debug mode "error", so a host synchronisation between
    columns raises; then each output against its input."""
    decoders, streams = resident_decoders(container)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [dec(s) for dec, s in zip(decoders, streams)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (v, col), u in zip(container, outs):
        check(same_on_card(u[: col.n], v), f"resident {col.name} is wrong")
    print(f"[main] {label} decoders on resident streams under sync debug mode 'error': no host sync, bit-exact")


def time_kernel(label: str, smi: str, name: str, args: tuple, nbytes: int, e2e, e2e_what: str, tail: str,
                in_bytes: int | None = None, e2e_runs: int = 10) -> dict:
    """Phase 5: the kernel on resident inputs (also held against its plain
    version at this shape), a same-size copy_, the plain version, and the
    end-to-end call (median of ``e2e_runs``); ``tail`` adds the uploads
    measured by the caller, ``in_bytes`` goes to bound()."""
    wrapper, plain = KERNELS[name][:2]
    out = wrapper(*args)
    compare(label, name, out, plain(*args))
    b_ms, b_by = bound(name, args, out, in_bytes)
    cell = ops_cell(label, name, args, out, in_bytes)
    del out
    k_ms = cuda_ms(lambda: wrapper(*args))
    src = torch.empty(nbytes // 4, dtype=torch.int32, device=CUDA)
    dst = torch.empty_like(src)
    c_ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    p_ms = cuda_ms(lambda: plain(*args), runs=10, warmup=1)
    e_ms = host_ms(e2e, runs=e2e_runs)
    k_gbs, c_gbs = nbytes / k_ms / 1e6, nbytes / c_ms / 1e6
    print(f"[time] {label} on {smi}: kernel {name} {k_ms:.4f} ms = {k_gbs:.1f} GB/s "
          f"{'encoded' if name == 'lmp_pack' else 'decoded'}; "
          f"copy_ of the same {nbytes} B {c_ms:.4f} ms = {c_gbs:.1f} GB/s; kernel/copy {k_gbs / c_gbs:.3f}; "
          f"plain PyTorch {p_ms:.4f} ms; end-to-end {e2e_what} {e_ms:.3f} ms; {tail} "
          f"(medians of 20 / 20 / 10 / {e2e_runs} runs, the rest of 10 unless stated); bound {b_ms:.4f} ms by {b_by}, kernel at "
          f"{b_ms / k_ms:.3f} of it")
    torch.cuda.empty_cache()
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ops": dict(cell, ms=k_ms)}


def ops_cell(label: str, name: str, args: tuple, out, in_bytes: int | None) -> dict:
    """What the [ops] phase needs of a timed call: the launches of kernel
    ``name`` on ``args`` (its wrapper module's census: instance, threads,
    loop trips; nothing is launched), its values and its bound's bytes."""
    return {"label": label, "name": name, "launches": kernels.WRAPPERS[name].census(name, args),
            "values": bound_values(name, args, out), "bytes": bound_bytes(args, out, in_bytes)}


def run_bytes(col, name: str, args: tuple) -> int | None:
    """The input a run expansion (K5, or K5 with the LUT stage) needs: each
    real run's value and end, 4 B each, and a cascade's dictionary. Its
    tile-form tables repeat runs that span tiles and pad each tile to w_pad,
    which is prep overhead, not work the function must do. None for any
    other kernel."""
    if not (name in ("run_expand", "run_filter") or name == "cascade_lut" and args[0] == "run_expand"):
        return None
    runs = int(col.streams["c_run_counts" if col.scheme == "cascade" else "run_counts"].sum())
    return runs * 8 + (col.streams["values"].nbytes if col.scheme == "cascade" else 0)


def time_column(label, v, col, smi) -> tuple[str, dict]:
    """Phase 5 for a column: end-to-end decode(col) includes host prep and
    the upload; beside it the upload of the streams alone and of the raw
    column it stands against."""
    name, args = kernel_call(col, gtt.device_streams(col, CUDA), gtt.narrow_store_dtype(col))
    u_ms = host_ms(lambda: gtt.device_streams(col, CUDA))
    r_ms = host_ms(lambda: torch.from_numpy(v).to(CUDA))
    in_bytes = run_bytes(col, name, args)
    tail = (f"host prep + H2D of the {col.nbytes_compressed} B of streams alone {u_ms:.3f} ms; "
            f"H2D of the raw column {r_ms:.3f} ms")
    if in_bytes is not None:
        tables = sum(t.numel() * t.element_size() for t in tensors(args))
        tail += f"; bound counts {in_bytes} B of runs, not the {tables} B of tile tables"
    timing = time_kernel(label, smi, name, args, col.nbytes_decoded,
                         lambda: gtt.decode(col, device=CUDA), "decode(col)", tail, in_bytes)
    if name == "run_expand":
        timing["library_ms"] = run_library(label, col, args, smi)
    return name, timing


def run_library(label: str, col, args: tuple, smi: str) -> float:
    """The one PyTorch call that expands runs, torch.repeat_interleave of
    an rle or rpe column's run values by their lengths, held equal to K5's
    output and timed (CUDA events, median of 20): ms."""
    ng, r_pad = num_groups(col.n), col.params["r_pad"]
    real = np.arange(r_pad)[None, :] < col.streams["run_counts"][:, None]
    if col.scheme == "rle":
        ends = col.streams["run_ends"].reshape(ng, r_pad).astype(np.int64)
        starts = np.concatenate([np.zeros((ng, 1), np.int64), ends[:, :-1]], axis=1)
    else:
        starts = col.streams["run_starts"].reshape(ng, r_pad).astype(np.int64)
        ends = np.concatenate([starts[:, 1:], np.full((ng, 1), GROUP, np.int64)], axis=1)
    values = torch.from_numpy(col.streams["run_values"].reshape(ng, r_pad)[real]).to(CUDA)
    lengths = torch.from_numpy((ends - starts)[real]).to(CUDA)
    expand = lambda: torch.repeat_interleave(values, lengths, output_size=ng * GROUP)  # noqa: E731
    check(torch.equal(expand(), rle.run_expand(*args).reshape(-1)), f"{label}: repeat_interleave != K5")
    ms = cuda_ms(expand)
    print(f"[time] {label} on {smi}: library torch.repeat_interleave(values, lengths, output_size=n_pad) over "
          f"{values.numel()} runs {ms:.4f} ms (median of 20), equal to K5's output")
    return ms


def time_dzbv(v: np.ndarray, col, picked: str, smi: str) -> dict:
    """Phase 5 for the dzbv column in each stream form: the form's kernel,
    its bound from the compressed streams (the re-anchored forms' padding is
    prep overhead, printed beside it), the host prep into the form alone
    (median of 3), H2D of the form's streams + kernel, and end to end: the
    prep's own form through decode(col), the others as prep + H2D + kernel
    (median of 3), the on-disk planes as H2D + kernel."""
    decoder = gtt.get_decoder(col)
    r_ms = host_ms(lambda: torch.from_numpy(v).to(CUDA))
    timings = {}
    for form, name in DZBV_FORMS.items():
        prep_ms = host_ms(lambda: dzbv.form_streams(col, form), runs=3) if form != "plane" else None
        streams = dzbv.form_streams(col, form)
        form_bytes = sum(a.nbytes for a in streams.values())
        up_ms = host_ms(lambda: decoder(gtt.upload(streams, CUDA)))
        k_name, args = kernels.kernel_call(col, gtt.upload(streams, CUDA), torch.int32)
        check(k_name == name, f"dzbv {form} form: kernel_call gave {k_name}")
        if form == picked:
            e2e, what = (lambda: gtt.decode(col, device=CUDA)), "decode(col), the prep's own form"
        elif form == "plane":
            e2e, what = (lambda: decoder(gtt.upload(col.streams, CUDA))), "H2D of the on-disk streams + kernel"
        else:
            e2e, what = (lambda: decoder(gtt.upload(dzbv.form_streams(col, form), CUDA))), f"prep into the {form} form + H2D + kernel"
        prep = f"host prep into the form {prep_ms:.3f} ms (median of 3)" if prep_ms is not None else "no host prep"
        tail = (f"{prep}; H2D of the {form_bytes} B of streams + kernel {up_ms:.3f} ms; the streams hold "
                f"{form_bytes - col.nbytes_compressed} B of padding beyond the {col.nbytes_compressed} B compressed; "
                f"H2D of the raw column {r_ms:.3f} ms")
        label = f"dzbv n=2^26 {dzbv_form(streams)}{' (the prep picks it)' if form == picked else ''}"
        timings[name] = time_kernel(label, smi, name, args, col.nbytes_decoded, e2e, what, tail,
                                    in_bytes=col.nbytes_compressed, e2e_runs=10 if form == "plane" else 3)
        del args
    return timings


def time_scan(x: torch.Tensor, smi: str) -> tuple[str, dict]:
    """Phase 5 for scan.group_prefix_sum on a resident tensor."""
    xc = x.to(CUDA)
    rows = xc.view(-1, GROUP)  # 2^26 is whole groups
    r_ms = host_ms(lambda: x.to(CUDA))
    lib_ms = cuda_ms(lambda: torch.cumsum(rows, 1, dtype=torch.int32))
    timing = time_kernel(
        "group_prefix_sum n=2^26", smi, "cumsum_rows", (rows,), x.numel() * 4,
        lambda: gtt.scan.group_prefix_sum(xc), "group_prefix_sum(x resident)",
        f"H2D of the raw column {r_ms:.3f} ms; library torch.cumsum(rows, 1, dtype=int32) {lib_ms:.4f} ms")
    return "cumsum_rows", dict(timing, library_ms=lib_ms)


def time_fold(label: str, smi: str, name: str, args: tuple) -> float:
    """K16 or K17 on resident inputs beside its bound, held against its
    plain version at this shape first; prints and returns its ms."""
    wrapper, plain = KERNELS[name][:2]
    out = wrapper(*args)
    compare(label, name, out, plain(*args))
    b_ms, b_by = bound(name, args, out)
    del out
    k_ms = cuda_ms(lambda: wrapper(*args), queued=True)
    print(f"[time] {label} on {smi}: kernel {name} {k_ms:.4f} ms (CUDA events, median of 20 queued runs); bound {b_ms:.4f} ms "
          f"by {b_by}, kernel at {b_ms / k_ms:.3f} of it")
    return k_ms


def time_scan_layer(scan: dict, smi: str) -> dict:
    """Phase 5 for K16 and K17 at configs[0] on resident packed words (and,
    printed with their bounds, K17 min there, both at the configs[1] FOR
    column and K17 sum on its 1%-null twin), and K19 at configs[3] as rle on
    its resident run tables: each
    kernel (also held against its plain version at this shape), its bound,
    its plain version and count_where / sum_ / count_between end to end,
    beside the unfused route at the same column -- K1's (K5's) decode, then
    the compare and the bit pack in torch ops (the general path's), or then
    a torch sum -- and the raw column's H2D. No single PyTorch call computes
    any of the three functions."""
    v, _, col = scan["configs[0] nbit"]
    packed, refs_g, bits, kind, itemsize = scan_args(col)
    value = 256
    key = query._stage_key(col.dtype, value)
    ng = packed.shape[0]
    r_ms = host_ms(lambda: torch.from_numpy(v).to(CUDA))
    unfused_filter = cuda_ms(lambda: lanes.pack_hits(
        query._cmp(nbit.lmp_unpack(packed, bits).view(ng, GROUP), key, "lt", kind, itemsize)))
    unfused_sum = cuda_ms(lambda: nbit.lmp_unpack(packed, bits).sum(dtype=torch.int64))
    min_ms = time_fold("configs[0] nbit 9-bit n=2^28 min", smi, "agg_fold",
                       (packed, refs_g, None, bits, col.n, kind, itemsize, "min"))
    for cell in ("configs[1] for", "configs[1] for 1% nulls"):
        fv, fvalid, fcol = scan[cell]
        fpacked, frefs, fbits, fkind, fsize = scan_args(fcol)
        vw = nulls.valid_words_device(fcol, CUDA) if fvalid is not None else None
        fkey = query._stage_key(fcol.dtype, int(fv[fv.shape[0] // 2]))
        label = f"{cell} {fbits}-bit n=2^26"
        if vw is None:
            time_fold(f"{label} filter lt", smi, "filter_fold", (fpacked, frefs, None, fbits, fkind, fsize, "lt", fkey))
        time_fold(f"{label} sum", smi, "agg_fold", (fpacked, frefs, vw, fbits, fcol.n, fkind, fsize, "sum"))
        del fpacked, frefs, vw
    timings = {"filter_fold": time_kernel(
        f"configs[0] nbit 9-bit n=2^28 filter lt {value}", smi, "filter_fold",
        (packed, refs_g, None, bits, kind, itemsize, "lt", key), col.nbytes_decoded,
        lambda: query.count_where(col, "lt", value, device=CUDA), f"query.count_where(col, 'lt', {value})",
        f"unfused K1 decode + torch compare and bit pack {unfused_filter:.4f} ms (CUDA events, median of 20); "
        f"H2D of the raw column {r_ms:.3f} ms")}
    timings["agg_fold"] = time_kernel(
        "configs[0] nbit 9-bit n=2^28 sum", smi, "agg_fold", (packed, refs_g, None, bits, col.n, kind, itemsize, "sum"),
        col.nbytes_decoded, lambda: aggregate.sum_(col, device=CUDA), "aggregate.sum_(col)",
        f"unfused K1 decode + torch int64 sum {unfused_sum:.4f} ms; K17 min {min_ms:.4f} ms (CUDA events, medians "
        f"of 20); H2D of the raw column {r_ms:.3f} ms")
    _, _, rcol = scan["configs[3] rle"]
    streams = gtt.device_streams(rcol, CUDA)
    w_pad = streams["vals_w"].shape[-1]
    ends, vals, rng_ = streams["ends_w"].reshape(-1, w_pad), streams["vals_w"].reshape(-1, w_pad), num_groups(rcol.n)
    rkey = query._stage_key(rcol.dtype, 2)
    general = cuda_ms(lambda: lanes.pack_hits(query._cmp(rle.run_expand(ends, vals, rng_), rkey, "ge", "i", 4)))
    rargs = (ends, vals, None, rng_, "i", 4, "ge", rkey)
    timings["run_filter"] = time_kernel(
        "configs[3] rle n=2^26 filter ge 2", smi, "run_filter", rargs, rcol.nbytes_decoded,
        lambda: query.count_between(rcol, 1, 3, device=CUDA), "query.count_between(col, 1, 3)",
        f"the general path, K5 decode + torch compare and bit pack {general:.4f} ms (CUDA events, median of 20); "
        f"T {ends.shape[0] // rng_} of w_pad {w_pad}", run_bytes(rcol, "run_filter", rargs))
    return timings


def pack_args(scheme: str, v: np.ndarray, host) -> tuple:
    """K18's arguments at a device-encode cell, on the card: the padded
    payloads (frame-padded for FOR, with the unsigned per-frame min as
    refs), or for dict the host column's codes unpacked."""
    bits = host.params["bits"]
    if scheme == "dict":
        ng = host.streams["codes"].shape[0]
        return lanes.unpack_lanes(to_card(host.streams["codes"].reshape(-1)).view(ng, -1), bits), bits, "none", None, None, GROUP
    if scheme == "for":
        frame_len = host.params["frame_len"]
        x = to_card(frame_pad(v, frame_len))
        refs = (x.view(-1, frame_len) ^ encode.INT_MIN).amin(1) ^ encode.INT_MIN
        return x.view(-1, GROUP), bits, "for_sub", refs, None, frame_len
    x = to_card(pad_to_groups(v.view(np.uint32))).view(-1, GROUP)
    return (x, bits, "delta_zigzag", None, v.shape[0], GROUP) if scheme == "delta" else (x, bits, "none", None, None, GROUP)


def time_encode(by_label: dict, smi: str) -> dict:
    """Phase 5 for device encode: K18 at configs[0] (no prologue), at
    configs[1] as delta and as FOR, and over configs[2]'s dictionary codes,
    on resident inputs (also held against its plain version there), each
    beside its device encoder end to end (host pad, H2D, device work, D2H
    of the streams; median of 10), the D2H of the packed words alone (and
    FOR's frame pad alone), the host encode of the same column and the raw
    column's H2D; rle's device encode end to end alone (no K18).
    Returns configs[0]'s K18 timing, the kernels line's row."""
    timings = {}
    for scheme, (label, v, host, fn) in device_encoders(by_label).items():
        r_ms = host_ms(lambda: torch.from_numpy(v).to(CUDA))
        tail = f"host encode of the column {HOST_ENCODE_S[label]:.3f} s ([encode]); H2D of the raw column {r_ms:.3f} ms"
        if scheme == "rle":
            e_ms = host_ms(fn)
            print(f"[time] {label} on {smi}: device encode end to end, encode_rle_device(v) {e_ms:.3f} ms (run tables "
                  f"in torch ops, no K18); {tail} (medians of 10)")
            continue
        args = pack_args(scheme, v, host)
        words = encode.lmp_pack(*args)
        tail += f"; D2H of the {words.numel() * 4} B of packed words alone {host_ms(lambda: words.cpu()):.3f} ms"
        del words
        if scheme == "for":
            tail += f"; host frame pad alone {host_ms(lambda: frame_pad(v, host.params['frame_len'])):.3f} ms"
        timing = time_kernel(f"{label} device encode {scheme}", smi, "lmp_pack", args, host.nbytes_decoded, fn,
                             f"device encode ({scheme})", tail)
        timings.setdefault("lmp_pack", timing)  # configs[0], the first
    return timings


def time_container(container: list, smi: str) -> None:
    """Phase 5 for configs[4]: decode_columns end to end, against the sum
    of the four single decode calls and the H2D of the four raw columns;
    the four kernels back to back on resident streams (CUDA events around
    the whole sequence)."""
    cols = [col for _, col in container]
    e_ms = host_ms(lambda: gtt.decode_columns(cols, device=CUDA))
    singles = [host_ms(lambda c=col: gtt.decode(c, device=CUDA)) for col in cols]
    u_ms = host_ms(lambda: [gtt.device_streams(col, CUDA) for col in cols])
    r_ms = host_ms(lambda: [torch.from_numpy(v).to(CUDA) for v, _ in container])
    decoders, streams = resident_decoders(container)
    k_ms = cuda_ms(lambda: [dec(s) for dec, s in zip(decoders, streams)])
    nbytes = sum(col.nbytes_decoded for col in cols)
    print(f"[time] configs[4] mixed container 4 x 2^26 on {smi}: decode_columns end to end {e_ms:.3f} ms; "
          f"sum of the four single decode(col) {sum(singles):.3f} ms "
          f"({', '.join(f'{c.name} {t:.3f}' for c, t in zip(cols, singles))}); host prep + H2D of the "
          f"{sum(c.nbytes_compressed for c in cols)} B of streams alone {u_ms:.3f} ms; H2D of the four raw "
          f"columns {r_ms:.3f} ms; the four decoders back to back on resident streams {k_ms:.4f} ms = "
          f"{nbytes / k_ms / 1e6:.1f} GB/s decoded, {k_ms / e_ms:.4f} of the end-to-end call "
          f"(medians of 10 host-clock runs, 20 CUDA-event runs)")
    torch.cuda.empty_cache()


def rank_column() -> tuple[np.ndarray, object]:
    """K5's cell of the reference's _rank_call: runs of 1-39 over 1000
    values, 2^26 values, seed 7; the prep picks 16 < w_pad <= 128 (T 32 of
    w_pad 128)."""
    v = run_column(np.random.default_rng(7), 2**26, 1, 40, vocab=1000)
    col = encoded("rle runs ~20 n=2^26 (_rank_call cell)", v, "rle")
    streams = rle.prep(col, positions=False)
    check("vals_w" in streams and rle.form(streams["vals_w"].shape[-1]) == "rank",
          f"the _rank_call cell missed 16 < w_pad <= 128: {[a.shape for a in streams.values()]}")
    return v, col


def rank_cell(rank: tuple, smi: str) -> dict:
    """Phase 5 for K5 at the _rank_call cell: its timing (time_column), for
    the run_expand row's rank form, with kernel/bound."""
    v, col = rank
    tiles, w_pad = rle.prep(col, positions=False)["vals_w"].shape[1:]
    _, timing = time_column(f"rle runs ~20 n=2^26 (_rank_call cell, T {tiles}, w_pad {w_pad})", v, col, smi)
    return {"cell": f"rle runs of 1-39 n=2^26, T {tiles}, w_pad {w_pad}", **timing,
            "kernel_over_bound": timing["bound_ms"] / timing["ms"]}


# -- the [ops] phase -------------------------------------------------------------
# The SASS census of each kernel at the cell its [time] line timed
# (roofline.sass_census on the built library's cuobjdump -sass): its
# instructions a value by pipe, the budget that memory leaves them, and the
# busiest pipe's floor, the least instructions a value that must run times
# the values over that pipe's rate at the maximum clock, beside the kernel's
# measured time. It launches nothing.

OPS_PIPES = [pipe for pipe in roofline.PER_SM_CLOCK if pipe != "issue"]


def ops_line(cell: dict, sass: str, smi: str) -> None:
    """One [ops] line; raises unless the census is closed (no unknown
    opcode, every loop found declared) and no floor exceeds the kernel's
    measured time."""
    values, name, label = cell["values"], cell["name"], cell["label"]
    c = roofline.census_of(cell["launches"], values, sass)
    rates = roofline.chip_rates()
    per_byte = cell["bytes"] / values / roofline.chip_bw()
    budget = {pipe: rate * per_byte for pipe, rate in rates.items()}
    floors = roofline.floors_ms(c, values)
    busiest = max(OPS_PIPES, key=lambda pipe: floors[pipe])
    top = max(OPS_PIPES, key=lambda pipe: c[f"{pipe}_per_elem"] / rates[pipe])
    memory_bound = all(c[f"{pipe}_per_elem"] <= budget[pipe] for pipe in rates)
    kernels_of = " + ".join(c["kernels"]) + (" (between them a torch cumsum, not counted)" if len(c["kernels"]) > 1 else "")
    print(f"[ops] {label} on {smi}: {name} = {kernels_of}; census a value: issue {c['issue_per_elem']:.2f} ("
          + ", ".join(f"{p} {c[f'{p}_per_elem']:.2f}" for p in (*OPS_PIPES, "uniform", "control", "unknown"))
          + f"), busiest pipe {top}; budget a value: issue {budget['issue']:.2f}, "
          + ", ".join(f"{p} {budget[p]:.2f}" for p in OPS_PIPES)
          + f"; memory_bound {memory_bound}; has_unbounded_loop {c['has_unbounded_loop']}; least that must run a "
          f"value: issue {c['floor_issue_per_elem']:.2f}, {busiest} {c[f'floor_{busiest}_per_elem']:.2f}; floors at "
          f"the maximum clock: issue {floors['issue']:.4f} ms, busiest pipe {busiest} {floors[busiest]:.4f} ms; "
          f"kernel {cell['ms']:.4f} ms (busiest floor/kernel {floors[busiest] / cell['ms']:.3f}, issue "
          f"{floors['issue'] / cell['ms']:.3f})", flush=True)
    check(c["unknown_per_elem"] == 0, f"[ops] {label}: {name}'s census holds unknown opcodes: "
          f"{[op for op in c['ops_per_elem'] if op.startswith('?')]}")
    check(not c["loops_mismatch"], f"[ops] {label}: {name}: the loops found in SASS are not those declared "
          f"(found {c['loops']})")
    for pipe, ms in floors.items():
        check(ms <= cell["ms"], f"[ops] {label}: {name}'s {pipe} floor {ms:.4f} ms exceeds its measured "
              f"{cell['ms']:.4f} ms: a rate or an opcode's class is wrong")


def ops_phase(cells: dict, rank: dict, smi: str) -> None:
    """The [ops] phase: the card's SM count and maximum clock against
    roofline.SM_CLOCK, then an [ops] line for each KERNELS row at its timed
    cell (K5 also at the _rank_call cell)."""
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    want_sms, want_clock = roofline.SM_CLOCK[name]
    print(f"[ops] {name} on {smi}: {sms} SMs (roofline.SM_CLOCK {want_sms}), nvidia-smi clocks.max.sm {clock} "
          f"(roofline.SM_CLOCK {want_clock / 1e6:.0f} MHz); rates a second: "
          + ", ".join(f"{pipe} {rate:.4g}" for pipe, rate in roofline.chip_rates().items()))
    check(sms == want_sms, f"[ops] {name} has {sms} SMs, roofline.SM_CLOCK says {want_sms}")
    t1 = time.perf_counter()
    sass = roofline.library_sass()
    t2 = time.perf_counter()
    for kernel in KERNELS:
        ops_line(cells[kernel], sass, smi)
        if kernel == "run_expand":
            ops_line(rank, sass, smi)
    print(f"[time] the [ops] phase: {time.perf_counter() - t0:.1f} s (cuobjdump -sass and cu++filt, or the "
          f"cached text, {t2 - t1:.1f} s; the census of {len(KERNELS) + 1} cells {time.perf_counter() - t2:.1f} s)")


# -- the analytic phase --------------------------------------------------------
# 64-bit and string columns, partial decode, zone maps, GROUP BY and top-k on
# two tables shaped after TPC-H (lineitem at n = 2^26, about SF 11; orders at
# n = 2^24, SF 11's orders). Every result is held exactly against NumPy on the
# input values (floats by their bits).

LINEITEM_N = 2**26
ORDERS_N = 2**24
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
AGGS = ("count", "sum", "min", "max")


@dataclasses.dataclass
class Column:
    """An analytic column: its input values, the encoded column and, for a
    strdict column, the vocabulary and each row's index into it."""

    label: str
    values: np.ndarray
    col: object
    vocab: np.ndarray | None = None
    idx: np.ndarray | None = None


def lineitem_table() -> dict[str, Column]:
    """l_orderkey (int64, sorted, 1-7 lines an order, TPC-H's sparse keys:
    8 of every 32 used) as wide with a delta lo plane and an nbit hi plane;
    l_extendedprice (float64, l_quantity times a part's retail price in
    cents, TPC-H's formula over 2.2M parts) as wide; l_quantity (int32,
    1-50) as nbit; l_suppkey (int32, 1000 keys) as dict. Seed 20."""
    n, rng = LINEITEM_N, np.random.default_rng(20)
    order = np.arange(n // 2, dtype=np.int64)  # 4 lines an order on average: twice the keys needed
    keys = order // 8 * 32 + order % 8 + 1
    orderkey = np.repeat(keys, rng.integers(1, 8, keys.shape[0]))[:n]
    quantity = rng.integers(1, 51, n).astype(np.int32)
    part = rng.integers(1, 2_200_001, n)
    retail_cents = 90000 + (part // 10) % 20001 + 100 * (part % 1000)
    price = (quantity * retail_cents) / 100.0
    vocab = (rng.choice(110_000, 1000, replace=False) + 1).astype(np.int32)
    suppkey = vocab[rng.integers(0, 1000, n)]
    return {
        "l_orderkey": Column("l_orderkey", orderkey, encoded("lineitem l_orderkey int64 wide n=2^26", orderkey, "wide",
                                                             base_scheme="delta", hi_scheme="nbit")),
        "l_extendedprice": Column("l_extendedprice", price, encoded("lineitem l_extendedprice float64 wide n=2^26", price,
                                                                    "wide")),
        "l_quantity": Column("l_quantity", quantity, encoded("lineitem l_quantity nbit n=2^26", quantity, "nbit")),
        "l_suppkey": Column("l_suppkey", suppkey, encoded("lineitem l_suppkey dict d=1000 n=2^26", suppkey, "dict")),
    }


def orders_table() -> dict[str, Column]:
    """o_orderstatus (3 strings, p = 0.1, 0.6, 0.3), o_orderpriority (5
    strings) and o_clerk (10,000 strings "Clerk#%09d"), each strdict with
    codes_scheme="auto", and o_custkey (int32 in 1..1,650,000) as nbit.
    Seed 21. The strings are one Python object a row, built on the host."""
    n, rng = ORDERS_N, np.random.default_rng(21)
    out = {}
    for name, vocab, idx in [
        ("o_orderstatus", ["F", "O", "P"], rng.choice(3, n, p=[0.1, 0.6, 0.3])),
        ("o_orderpriority", PRIORITIES, rng.integers(0, 5, n)),
        ("o_clerk", [f"Clerk#{i:09d}" for i in range(1, 10_001)], rng.integers(0, 10_000, n)),
    ]:
        vocab = np.array(vocab, dtype=object)
        values = vocab[idx]
        out[name] = Column(name, values, encoded(f"orders {name} strdict n=2^24", values, "strdict"), vocab, idx)
    custkey = rng.integers(1, 1_650_001, n).astype(np.int32)
    out["o_custkey"] = Column("o_custkey", custkey, encoded("orders o_custkey nbit n=2^24", custkey, "nbit"))
    return out


def analytic_kernel_checks(li: dict, od: dict) -> None:
    """Each kernel of the analytic paths against its plain version on the
    card at their shapes: both planes of the two wide columns, the dict
    codes and every strdict code column (check_kernel)."""
    for name in ("l_orderkey", "l_extendedprice"):
        c = li[name]
        u = c.values.view(np.uint64)
        for plane, half in (("lo", u & np.uint64(0xFFFFFFFF)), ("hi", u >> np.uint64(32))):
            check_kernel(f"lineitem {name} {plane} plane n=2^26", wide._sub(c.col, plane), half.astype(np.uint32))
    codes = groupby._codes_device_column(li["l_suppkey"].col)
    check_kernel("lineitem l_suppkey codes n=2^26", codes, np.searchsorted(np.unique(li["l_suppkey"].values),
                                                                            li["l_suppkey"].values).astype(np.int32))
    for name in ("o_orderstatus", "o_orderpriority", "o_clerk"):
        c = od[name]
        used = np.unique(c.idx)
        code_of = np.zeros(c.vocab.shape[0], np.int32)  # each used entry's code in the sorted dictionary
        code_of[used[np.argsort(c.vocab[used].astype(str))]] = np.arange(used.shape[0])
        check_kernel(f"orders {name} codes n=2^24", strings.codes_column(c.col), code_of[c.idx])


def group_oracle(codes: np.ndarray, vals: np.ndarray, d: int, hi: int, mask: np.ndarray | None = None) -> tuple:
    """NumPy GROUP BY of small non-negative values (< hi) by code: counts,
    exact sums, mins and maxs from one (code, value) histogram."""
    if mask is not None:
        codes, vals = codes[mask], vals[mask]
    hist = np.bincount(codes.astype(np.int64) * hi + vals, minlength=d * hi).reshape(d, hi)
    seen = hist > 0
    return (hist.sum(1), hist @ np.arange(hi, dtype=np.int64), seen.argmax(1).astype(np.int64),
            (hi - 1 - seen[:, ::-1].argmax(1)).astype(np.int64))


def same_group(r, keys: np.ndarray, want: tuple) -> bool:
    count, total, lo, hi = want
    return (np.array_equal(r.keys, keys) and r.keys.dtype == keys.dtype and r.count.dtype == np.int64
            and all(np.array_equal(a, b) for a, b in zip((r.count, r.sum, r.min, r.max), (count, total, lo, hi))))


def stable_top(keys: np.ndarray, k: int, largest: bool) -> np.ndarray:
    """The positions that NumPy's stable argsort puts last k (reversed: equal
    keys highest position first) or first k, found through a partition."""
    t = np.partition(keys, keys.size - k if largest else k - 1)[keys.size - k if largest else k - 1]
    cand = np.flatnonzero(keys >= t if largest else keys <= t)
    order = np.lexsort((-cand, -keys[cand]) if largest else (cand, keys[cand]))
    return cand[order][:k]


def same_topk(got: tuple, v: np.ndarray, pos: np.ndarray) -> bool:
    vals, p = got
    return np.array_equal(p, pos) and same_bits(vals, v[pos])


def words_of(mask: np.ndarray) -> torch.Tensor:
    """The LMP(1) words of a whole-groups mask, packed on the card."""
    return lanes.pack_hits(torch.from_numpy(mask).to(CUDA).view(-1, GROUP))


def analytic_main_path(li: dict, od: dict, drive) -> None:
    """The analytic phase's paths (see the module docstring of each entry
    point), each driven once with the launch counts reset and read around
    it, each held exactly against NumPy on the input."""
    ok, okc = li["l_orderkey"].values, li["l_orderkey"].col
    price, pricec = li["l_extendedprice"].values, li["l_extendedprice"].col
    qty, qtyc = li["l_quantity"].values, li["l_quantity"].col
    supp, suppc = li["l_suppkey"].values, li["l_suppkey"].col
    drive("lineitem l_orderkey wide n=2^26", "decode(col, device=cuda) vs input",
          lambda: same_on_card(gtt.decode(okc, device=CUDA), ok), ("delta_decode", "lmp_unpack"))
    drive("lineitem l_extendedprice wide n=2^26", "decode(col, device=cuda) vs input",
          lambda: same_on_card(gtt.decode(pricec, device=CUDA), price), ("lmp_unpack",))
    med, one = int(ok[ok.shape[0] // 2]), int(ok[12345])
    counts = {"lt": int((ok < med).sum()), "eq": int((ok == one).sum())}
    for op, value in (("lt", med), ("eq", one)):
        drive(f"lineitem l_orderkey count_where {op}", "query.count_where(col, device=cuda) vs NumPy",
              lambda: query.count_where(okc, op, value, device=CUDA) == counts[op], ("delta_decode", "lmp_unpack"))
        drive(f"lineitem l_orderkey filter_bitmap {op}", "query.filter_bitmap(col, device=cuda) vs NumPy's mask",
              lambda: torch.equal(query.filter_bitmap(okc, op, value, device=CUDA),
                                  words_of(ok < med if op == "lt" else ok == one)))
    drive("lineitem l_orderkey sum_/min_/max_", "aggregate.sum_/min_/max_(col, device=cuda) vs NumPy",
          lambda: (aggregate.sum_(okc, device=CUDA) == int(ok.sum()) and aggregate.min_(okc, device=CUDA) == int(ok.min())
                   and aggregate.max_(okc, device=CUDA) == int(ok.max())), ("delta_decode", "agg_fold", "filter_fold"))
    for op, value in (("lt", med), ("eq", one)):
        drive(f"lineitem l_orderkey count_where_pruned {op}", "zonemap.count_where_pruned vs count_where and NumPy",
              lambda: zonemap.count_where_pruned(okc, op, value, device=CUDA) == counts[op]
              == query.count_where(okc, op, value, device=CUDA))
    q = np.concatenate([ok[np.random.default_rng(22).integers(0, ok.shape[0], 1000)], [0, int(ok[-1]) + 1]])
    drive("lineitem l_orderkey searchsorted", "zonemap.searchsorted(col, 1002 keys) vs np.searchsorted, both sides",
          lambda: all(np.array_equal(zonemap.searchsorted(okc, q, side=side, device=CUDA), np.searchsorted(ok, q, side=side))
                      for side in ("left", "right")), ("delta_decode",))
    thr = float(np.partition(price, price.shape[0] - price.shape[0] // 1000)[price.shape[0] - price.shape[0] // 1000])
    drive("lineitem l_extendedprice select_where gt (0.1%)", "query.select_where(col, device=cuda) vs NumPy",
          lambda: same_bits(query.select_where(pricec, "gt", thr, device=CUDA), price[price > thr]), ("lmp_unpack",))
    idx = np.random.default_rng(23).integers(0, ok.shape[0], ok.shape[0] // 1000)
    drive("lineitem l_orderkey take (0.1% of the rows)", "partial.take(col, idx, device=cuda) vs NumPy",
          lambda: same_bits(partial.take(okc, idx, device=CUDA), ok[idx]), ("delta_decode",))
    skeys = np.unique(supp)
    scodes = np.searchsorted(skeys, supp)
    for label, bm, mask in (("", None, None), (" where l_orderkey < median", True, ok < med)):
        want = group_oracle(scodes, qty, skeys.shape[0], 51, mask)
        drive(f"lineitem group_reduce(l_suppkey, l_quantity){label}", "groupby.group_reduce(..., device=cuda) vs NumPy",
              lambda: same_group(groupby.group_reduce(
                  suppc, qtyc, AGGS, None if bm is None else query.filter_bitmap(okc, "lt", med, device=CUDA),
                  device=CUDA), skeys, want), ("lmp_unpack",))
    top = stable_top(price, 100, largest=True)
    drive("lineitem top_k(l_extendedprice, 100)", "topk.top_k(col, 100, device=cuda) vs NumPy's stable argsort",
          lambda: same_topk(topk.top_k(pricec, 100, device=CUDA), price, top), ("lmp_unpack",))
    low = stable_top(qty, 100, largest=False)
    drive("lineitem top_k(l_quantity, 100, largest=False), ties", "topk.top_k(col, device=cuda) vs NumPy's stable argsort",
          lambda: same_topk(topk.top_k(qtyc, 100, largest=False, device=CUDA), qty, low), ("lmp_unpack",))

    for name in ("o_orderstatus", "o_orderpriority", "o_clerk"):
        c = od[name]
        drive(f"orders {name} strdict n=2^24 ({c.col.params['codes_scheme']} codes)", "decode(col, device=cuda) vs input",
              lambda: np.array_equal(gtt.decode(c.col, device=CUDA), c.values))
    preds = [("o_orderstatus", "eq", "F", lambda e: e == "F"),
             ("o_clerk", "startswith", "Clerk#00000", lambda e: e.startswith("Clerk#00000")),
             ("o_clerk", "contains", "999", lambda e: "999" in e),
             ("o_orderpriority", "contains", "HIGH", lambda e: "HIGH" in e)]
    for name, op, value, fn in preds:
        c = od[name]
        mask = np.array([fn(e) for e in c.vocab])[c.idx]
        drive(f"orders {name} filter_bitmap_str {op} {value!r}", "strings.filter_bitmap_str(col, device=cuda) vs NumPy",
              lambda: torch.equal(strings.filter_bitmap_str(c.col, op, value, device=CUDA), words_of(mask)))
    for name, picks in (("o_orderpriority", PRIORITIES[:2]), ("o_clerk", list(od["o_clerk"].vocab[::97]))):
        c = od[name]
        mask = np.isin(c.idx, [int(np.flatnonzero(c.vocab == p)[0]) for p in picks])
        drive(f"orders {name} isin_bitmap_str ({len(picks)} strings)", "strings.isin_bitmap_str(col, device=cuda) vs NumPy",
              lambda: torch.equal(strings.isin_bitmap_str(c.col, picks, device=CUDA), words_of(mask)))
    c, cust = od["o_orderpriority"], od["o_custkey"]
    want = (np.bincount(c.idx, minlength=5), np.bincount(c.idx, weights=cust.values, minlength=5).astype(np.int64),
            np.array([cust.values[c.idx == g].min() for g in range(5)], np.int64),
            np.array([cust.values[c.idx == g].max() for g in range(5)], np.int64))
    drive("orders group_reduce(o_orderpriority, o_custkey)", "groupby.group_reduce(..., device=cuda) vs NumPy",
          lambda: same_group(groupby.group_reduce(c.col, cust.col, AGGS, device=CUDA), np.array(PRIORITIES, object), want))
    c = od["o_clerk"]
    drive("orders o_clerk select_where_str lt 'Clerk#000000011' (0.1%)", "strings.select_where_str(col, device=cuda) vs NumPy",
          lambda: np.array_equal(strings.select_where_str(c.col, "lt", "Clerk#000000011", device=CUDA), c.values[c.idx < 10]))
    for name in ("o_orderstatus", "o_orderpriority", "o_clerk"):
        c = od[name]
        used = sorted(c.vocab[np.bincount(c.idx, minlength=c.vocab.shape[0]) > 0])
        check(strings.min_str(c.col) == used[0] and strings.max_str(c.col) == used[-1]
              and strings.distinct_count_str(c.col) == len(used), f"orders {name} min_str/max_str/distinct_count_str")
        print(f"[main] orders {name} min_str/max_str/distinct_count_str: exact, from the dictionary (no device work)")


def time_analytic(li: dict, od: dict, smi: str) -> None:
    """Phase 5 for the analytic paths: each call's host-clock ms (median of
    10, or of 3 where a host step takes seconds) beside the H2D of the
    same values raw (a strdict column's raw values as fixed-width bytes);
    the zone map's build (one oracle decode on the host) alone."""
    raw = {name: host_ms(lambda c=c: torch.from_numpy(c.values).to(CUDA)) for name, c in li.items()}
    for name, c in od.items():
        if c.vocab is not None:  # the strings as a fixed-width byte array
            b = np.array([v.encode() for v in c.vocab], dtype="S")[c.idx].view(np.uint8)
            raw[name] = host_ms(lambda b=b: torch.from_numpy(b).to(CUDA))
    raw["o_custkey"] = host_ms(lambda: torch.from_numpy(od["o_custkey"].values).to(CUDA))
    ok, okc = li["l_orderkey"].values, li["l_orderkey"].col
    med, one = int(ok[ok.shape[0] // 2]), int(ok[12345])
    fresh = dataclasses.replace(okc)
    t0 = time.perf_counter()
    zonemap.zone_map(fresh)
    print(f"[time] lineitem l_orderkey zone map build on {smi}: {(time.perf_counter() - t0) * 1e3:.1f} ms on the host "
          f"(the NumPy oracle decode of both planes and the per-group bounds; once a column)")
    price, pricec = li["l_extendedprice"].values, li["l_extendedprice"].col
    thr = float(np.partition(price, price.shape[0] - price.shape[0] // 1000)[price.shape[0] - price.shape[0] // 1000])
    idx = np.random.default_rng(23).integers(0, ok.shape[0], ok.shape[0] // 1000)
    q = ok[np.random.default_rng(22).integers(0, ok.shape[0], 1000)]
    suppc, qtyc = li["l_suppkey"].col, li["l_quantity"].col
    bm = query.filter_bitmap(okc, "lt", med, device=CUDA)
    cells = [
        ("l_orderkey", "decode(col)", lambda: gtt.decode(okc, device=CUDA), 10),
        ("l_extendedprice", "decode(col)", lambda: gtt.decode(pricec, device=CUDA), 10),
        ("l_orderkey", "count_where lt median", lambda: query.count_where(okc, "lt", med, device=CUDA), 10),
        ("l_orderkey", "count_where eq one key", lambda: query.count_where(okc, "eq", one, device=CUDA), 10),
        ("l_orderkey", "filter_bitmap lt median", lambda: query.filter_bitmap(okc, "lt", med, device=CUDA), 10),
        ("l_orderkey", "sum_", lambda: aggregate.sum_(okc, device=CUDA), 10),
        ("l_orderkey", "min_ (zone map)", lambda: aggregate.min_(okc, device=CUDA), 10),
        ("l_orderkey", "count_where_pruned lt median", lambda: zonemap.count_where_pruned(okc, "lt", med, device=CUDA), 10),
        ("l_orderkey", "count_where_pruned eq one key", lambda: zonemap.count_where_pruned(okc, "eq", one, device=CUDA), 10),
        ("l_orderkey", "searchsorted 1000 keys", lambda: zonemap.searchsorted(okc, q, device=CUDA), 10),
        ("l_extendedprice", "select_where gt (0.1%)", lambda: query.select_where(pricec, "gt", thr, device=CUDA), 3),
        ("l_orderkey", "take 0.1% of the rows", lambda: partial.take(okc, idx, device=CUDA), 3),
        ("l_quantity", "group_reduce(l_suppkey, l_quantity)", lambda: groupby.group_reduce(suppc, qtyc, AGGS, device=CUDA), 10),
        ("l_quantity", "group_reduce(...) with the filter bitmap",
         lambda: groupby.group_reduce(suppc, qtyc, AGGS, bm, device=CUDA), 10),
        ("l_extendedprice", "top_k 100", lambda: topk.top_k(pricec, 100, device=CUDA), 10),
        ("l_quantity", "top_k 100 smallest", lambda: topk.top_k(qtyc, 100, largest=False, device=CUDA), 10),
    ]
    for name in ("o_orderstatus", "o_orderpriority", "o_clerk"):
        c = od[name].col
        cells.append((name, "decode(col) (codes on the card, string gather on the host)",
                      lambda c=c: gtt.decode(c, device=CUDA), 3))
    cells += [
        ("o_orderstatus", "filter_bitmap_str eq 'F'", lambda: strings.filter_bitmap_str(od["o_orderstatus"].col, "eq", "F",
                                                                                          device=CUDA), 10),
        ("o_clerk", "filter_bitmap_str startswith 'Clerk#00000'", lambda: strings.filter_bitmap_str(
            od["o_clerk"].col, "startswith", "Clerk#00000", device=CUDA), 10),
        ("o_clerk", "filter_bitmap_str contains '999'", lambda: strings.filter_bitmap_str(
            od["o_clerk"].col, "contains", "999", device=CUDA), 10),
        ("o_orderpriority", "isin_bitmap_str 2 strings", lambda: strings.isin_bitmap_str(
            od["o_orderpriority"].col, PRIORITIES[:2], device=CUDA), 10),
        ("o_custkey", "group_reduce(o_orderpriority, o_custkey)", lambda: groupby.group_reduce(
            od["o_orderpriority"].col, od["o_custkey"].col, AGGS, device=CUDA), 10),
        ("o_clerk", "min_str/max_str/distinct_count_str", lambda: (strings.min_str(od["o_clerk"].col), strings.max_str(
            od["o_clerk"].col), strings.distinct_count_str(od["o_clerk"].col)), 10),
        ("o_clerk", "select_where_str lt 'Clerk#000000011' (0.1%)", lambda: strings.select_where_str(
            od["o_clerk"].col, "lt", "Clerk#000000011", device=CUDA), 3),
    ]
    for name, what, fn, runs in cells:
        table = "lineitem" if name.startswith("l_") else "orders"
        n = LINEITEM_N if table == "lineitem" else ORDERS_N
        ms = host_ms(fn, runs=runs)
        print(f"[time] {table} {name} {what} n=2^{n.bit_length() - 1} on {smi}: {ms:.3f} ms (host clock, median of {runs}); "
              f"H2D of the raw {name} {raw[name]:.3f} ms")
    torch.cuda.empty_cache()


# -- the tables phase -----------------------------------------------------------
# The table engine on the card: a TPC-H customer table at SF 11 built through
# the advisor, the customer-orders joins, Table calls over the analytic
# phase's lineitem and orders columns, a four-partition lineitem dataset,
# streamed scans of configs[0] with their peak memory, the advisor, the CLI
# and the port's selftest. Every result is held exactly against NumPy on the
# input values (floats by their bits).

CUSTOMER_N = 1_650_000  # TPC-H customer at SF 11
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PARTITIONS = 4
CLI_N = 2**22 + 999
SELFTEST_N = 2**22 + 999


@dataclasses.dataclass
class Tables:
    """The tables phase's inputs: the Tables, the customer arrays, and the
    configs[0]/[1]/[3] columns (values, encoded column) it streams and
    advises on."""

    customer: object
    cust: dict
    lineitem: object
    orders: object
    li: dict
    od: dict
    c0: tuple
    ts: tuple
    flags: tuple


def customer_arrays() -> dict:
    """TPC-H customer at SF 11, seed 22: c_custkey 1..n in order,
    c_nationkey 0-24, c_mktsegment one of five strings, c_acctbal float64
    in [-999.99, 9999.99] at cent steps."""
    n, rng = CUSTOMER_N, np.random.default_rng(22)
    return {
        "c_custkey": np.arange(1, n + 1, dtype=np.int32),
        "c_nationkey": rng.integers(0, 25, n).astype(np.int32),
        "c_mktsegment": np.array(SEGMENTS, dtype=object)[rng.integers(0, 5, n)],
        "c_acctbal": rng.integers(-99_999, 1_000_000, n) / 100.0,
    }


def picks(t) -> str:
    """Each column's scheme (a wide column's plane schemes, a strdict's codes)."""
    def one(c):
        if c.scheme == "wide":
            return f"wide({c.params['lo_scheme']}/{c.params['hi_scheme']})"
        if c.scheme == "strdict":
            return f"strdict({c.params['codes_scheme']})"
        return c.scheme
    return ", ".join(f"{nm}={one(t[nm])}" for nm in t.names)


def tables_setup(li: dict, od: dict, cols: list) -> Tables:
    """The customer Table through Table.from_arrays (the advisor picks) and
    its container round trip; lineitem and orders as Tables over shallow
    copies of the analytic phase's encoded columns, renamed to their TPC-H
    names (nothing is re-encoded)."""
    cust = customer_arrays()
    t0 = time.perf_counter()
    customer = gtt.Table.from_arrays(cust, device=CUDA)
    print(f"[encode] customer SF 11 n={CUSTOMER_N}: Table.from_arrays {time.perf_counter() - t0:.2f} s on the host, "
          f"advisor picks {picks(customer)}")
    with tempfile.TemporaryDirectory() as d:
        customer.save(f"{d}/customer.gtp")
        again = gtt.Table.open(f"{d}/customer.gtp", device=CUDA)
        check(again.to_bytes() == customer.to_bytes() and again.names == customer.names, "customer save/open round trip")
    print("[main] customer save/open: the reopened container's bytes are equal")
    lineitem = gtt.Table([dataclasses.replace(c.col, name=name) for name, c in li.items()], device=CUDA)
    orders = gtt.Table([dataclasses.replace(c.col, name=name) for name, c in od.items()], device=CUDA)
    by_label = {label: (v, col) for label, v, col in cols}
    return Tables(customer, cust, lineitem, orders, li, od, by_label["configs[0] nbit 9-bit n=2^28"],
                  by_label["configs[1] delta n=2^26"], by_label["configs[3] rle n=2^26"])


def rows_of(bm, n: int) -> np.ndarray:
    """The set rows of a bitmap over n rows (pad bits ignored)."""
    return gtt.table._bitmap_indices(bm, n)


def host_only(label: str, what: str, fn) -> None:
    """A call that must answer on the host alone: exact, and no kernel."""
    kernels.reset_launches()
    ok = fn()
    launched = {k: c for k, c in kernels.launches().items() if c}
    check(ok, f"{label}: {what} is wrong")
    check(not launched, f"{label}: launched {launched}, where the host answers alone")
    print(f"[main] {label}: {what} exact; no kernel (the host answers)")


def join_pairs(left: np.ndarray, right_keys: np.ndarray, how: str) -> tuple[np.ndarray, np.ndarray]:
    """NumPy sort-merge of an equi-join whose right keys are unique: pairs
    in left-major order, unmatched left rows with -1 (``how="left"``)."""
    order = np.argsort(right_keys, kind="stable")
    pos = np.minimum(np.searchsorted(right_keys[order], left), right_keys.shape[0] - 1)
    hit = right_keys[order][pos] == left
    if how == "inner":
        return np.flatnonzero(hit).astype(np.int64), order[pos[hit]].astype(np.int64)
    return np.arange(left.shape[0], dtype=np.int64), np.where(hit, order[pos], -1).astype(np.int64)


def tables_main_path(tb: Tables, drive) -> None:
    """The tables phase's paths, each driven once with the launch counts
    reset and read around it, each exact against NumPy on the input."""
    cust, customer, orders, lineitem = tb.cust, tb.customer, tb.orders, tb.lineitem
    ckey, ocust = cust["c_custkey"], tb.od["o_custkey"].values
    drive("orders.semi_join(o_custkey, customer, c_custkey)", "Table.semi_join(device=cuda) vs np.isin",
          lambda: np.array_equal(rows_of(orders.semi_join("o_custkey", customer, "c_custkey"), ORDERS_N),
                                 np.flatnonzero(np.isin(ocust, ckey))), ("lmp_unpack",))
    seg = cust["c_mktsegment"]
    building = customer.filter(("c_mktsegment", "eq", "BUILDING"))
    bkeys = ckey[seg == "BUILDING"]
    check(building.n == bkeys.shape[0] and np.array_equal(building.take("c_custkey", np.arange(building.n)), bkeys),
          "customer.filter(c_mktsegment eq BUILDING)")
    print(f"[main] customer.filter(c_mktsegment eq BUILDING): {building.n} rows re-encoded, picks {picks(building)}")
    drive("orders.semi_join(o_custkey, BUILDING customers)", "Table.semi_join(device=cuda) vs np.isin",
          lambda: np.array_equal(rows_of(orders.semi_join("o_custkey", building, "c_custkey"), ORDERS_N),
                                 np.flatnonzero(np.isin(ocust, bkeys))), ("lmp_unpack",))
    no_order = np.flatnonzero(~np.isin(ckey, ocust))
    drive("customer.anti_join(c_custkey, orders, o_custkey)", f"Table.anti_join(device=cuda) vs NumPy ({no_order.size} "
          f"customers without an order)",
          lambda: np.array_equal(rows_of(customer.anti_join("c_custkey", orders, "o_custkey"), CUSTOMER_N), no_order),
          ("lmp_unpack",))
    for how in ("inner", "left"):
        want = join_pairs(ocust, bkeys, how)
        drive(f"join_indices(o_custkey, BUILDING c_custkey, how={how})",
              f"join.join_indices(device=cuda) vs a NumPy sort-merge, {want[0].size} pairs in left-major order",
              lambda: all(np.array_equal(g, w) for g, w in zip(
                  gtt.join_indices(orders["o_custkey"], building["c_custkey"], how=how, device=CUDA), want)),
              ("lmp_unpack",))
    li_w, ri_w = join_pairs(ocust, bkeys, "inner")
    bal = building.take("c_acctbal", np.arange(building.n))
    check(same_bits(bal, cust["c_acctbal"][seg == "BUILDING"]), "BUILDING c_acctbal")

    def joined() -> bool:
        rows, li_g, ri_g = orders.join("o_custkey", building, "c_custkey", select=["o_custkey", "o_orderpriority"],
                                       other_select=["c_mktsegment", "c_acctbal"])
        pri = tb.od["o_orderpriority"]
        return (np.array_equal(li_g, li_w) and np.array_equal(ri_g, ri_w)
                and np.array_equal(rows["o_custkey"], ocust[li_w])
                and np.array_equal(rows["o_orderpriority"], pri.values[li_w])
                and bool((rows["c_mktsegment"] == "BUILDING").all()) and same_bits(rows["c_acctbal"], bal[ri_w]))

    drive("orders.join(building, other_select=[c_mktsegment, c_acctbal])",
          "Table.join(device=cuda) vs NumPy rows", joined, ("lmp_unpack",))

    nation = cust["c_nationkey"]
    m_all, m_any = (seg == "BUILDING") & (nation < 5), (seg == "MACHINERY") | (nation == 24)
    drive("customer.count(c_mktsegment eq BUILDING, c_nationkey lt 5)", "Table.count(device=cuda) vs NumPy",
          lambda: customer.count(("c_mktsegment", "eq", "BUILDING"), ("c_nationkey", "lt", 5)) == int(m_all.sum()))
    drive("customer.where_all(...)", "Table.where_all(device=cuda) rows vs NumPy",
          lambda: np.array_equal(rows_of(customer.where_all(("c_mktsegment", "eq", "BUILDING"), ("c_nationkey", "lt", 5)),
                                         CUSTOMER_N), np.flatnonzero(m_all)))
    drive("customer.where_any(c_mktsegment eq MACHINERY, c_nationkey eq 24)", "Table.where_any(device=cuda) rows vs NumPy",
          lambda: np.array_equal(rows_of(customer.where_any(("c_mktsegment", "eq", "MACHINERY"), ("c_nationkey", "eq", 24)),
                                         CUSTOMER_N), np.flatnonzero(m_any)))
    qty, price = tb.li["l_quantity"].values, tb.li["l_extendedprice"].values
    qsum = int(qty.astype(np.int64).sum())
    # (column, aggregate, NumPy's answer, whether the card computes it: the
    # rest answer from a dictionary, a zone map or the validity count)
    for name, agg_, want, on_card in (
            ("l_quantity", "sum", qsum, True), ("l_quantity", "min", int(qty.min()), True),
            ("l_quantity", "max", int(qty.max()), True), ("l_quantity", "avg", qsum / qty.size, True),
            ("l_quantity", "count", qty.size, False), ("l_quantity", "distinct", int(np.unique(qty).size), True),
            ("l_extendedprice", "sum", float(np.sum(price, dtype=np.float64)), True),
            ("l_extendedprice", "max", float(price.max()), False),
            ("l_orderkey", "min", int(tb.li["l_orderkey"].values[0]), False),
            ("l_suppkey", "distinct", int(np.unique(tb.li["l_suppkey"].values).size), False)):
        (drive if on_card else host_only)(
            f"lineitem.agg({name}, {agg_})", "Table.agg(device=cuda) vs NumPy",
            lambda: (lambda got: type(got) is type(want) and got == want)(lineitem.agg(name, agg_)))
    pidx = tb.od["o_orderpriority"].idx
    want_g = (np.bincount(pidx, minlength=5), np.bincount(pidx, weights=ocust, minlength=5).astype(np.int64))
    drive("orders.groupby(o_orderpriority, o_custkey, (count, sum))", "Table.groupby(device=cuda) vs NumPy",
          lambda: (lambda r: np.array_equal(r.keys, np.array(PRIORITIES, object)) and np.array_equal(r.count, want_g[0])
                   and np.array_equal(r.sum, want_g[1]))(orders.groupby("o_orderpriority", "o_custkey", ("count", "sum"))))
    ok = tb.li["l_orderkey"].values
    k = LINEITEM_N // 1000
    drive("lineitem.select([l_quantity, l_suppkey], l_orderkey 0.1% bitmap)", "Table.select(device=cuda) vs NumPy",
          lambda: (lambda r: np.array_equal(r["l_quantity"], qty[ok < ok[k]]) and np.array_equal(
              r["l_suppkey"], tb.li["l_suppkey"].values[ok < ok[k]]))(
              lineitem.select(["l_quantity", "l_suppkey"], lineitem.where("l_orderkey", "lt", int(ok[k])))))
    top = np.lexsort((np.arange(ORDERS_N), -ocust.astype(np.int64)))[:10]  # lax.top_k's order: lowest position first
    od = tb.od

    def topk_ok() -> bool:
        vals, pos, rows = orders.top_k("o_custkey", 10, select=["o_clerk", "o_orderpriority"])
        return (np.array_equal(pos, top) and np.array_equal(vals, ocust[top])
                and np.array_equal(rows["o_clerk"], od["o_clerk"].values[top])
                and np.array_equal(rows["o_orderpriority"], od["o_orderpriority"].values[top]))

    drive("orders.top_k(o_custkey, 10, select=[o_clerk, o_orderpriority])", "Table.top_k(device=cuda) vs NumPy",
          topk_ok, ("lmp_unpack",))
    bal_all = cust["c_acctbal"]
    key = bal_all.view(np.uint64)
    key = np.where(key >> np.uint64(63), ~key, key | np.uint64(2**63))  # IEEE total order
    order = np.lexsort((np.arange(CUSTOMER_N), key, nation))

    def sorted_ok() -> bool:
        t = customer.sort_by(["c_nationkey", "c_acctbal"])
        got = t.select()
        return (all(np.array_equal(got[nm], cust[nm][order]) for nm in ("c_custkey", "c_nationkey", "c_mktsegment"))
                and same_bits(got["c_acctbal"], bal_all[order]))

    drive("customer.sort_by([c_nationkey, c_acctbal])", "Table.sort_by(device=cuda), decoded, vs np.lexsort", sorted_ok)
    dataset_main_path(tb, drive)
    stream_main_path(tb, drive)
    advisor_main_path(tb, drive)
    cli_main_path(drive)
    selftest_main_path(drive)


def lineitem_partitions(tb: Tables) -> list:
    """lineitem's l_orderkey, l_quantity and l_suppkey in PARTITIONS equal
    partitions, each a Table.from_arrays (the advisor picks)."""
    size = LINEITEM_N // PARTITIONS
    return [gtt.Table.from_arrays({nm: tb.li[nm].values[p * size : (p + 1) * size]
                                   for nm in ("l_orderkey", "l_quantity", "l_suppkey")}, device=CUDA)
            for p in range(PARTITIONS)]


DATASET_DIR: list = []  # the tables phase's scratch directory (a TemporaryDirectory), removed at exit


def dataset_main_path(tb: Tables, drive) -> None:
    """Dataset.write of four lineitem partitions, then _plan, count, agg,
    groupby, select and compact on it."""
    from giddy_tpu_torch.dataset import Dataset

    tmp = tempfile.TemporaryDirectory()
    DATASET_DIR.append(tmp)
    t0 = time.perf_counter()
    parts = lineitem_partitions(tb)
    enc_s = time.perf_counter() - t0
    print(f"[encode] lineitem {PARTITIONS} partitions x {LINEITEM_N // PARTITIONS}: Table.from_arrays {enc_s:.2f} s, "
          f"advisor picks {picks(parts[0])}")
    drive("lineitem Dataset.write (4 partitions)", "Dataset.write(device=cuda): zones vs NumPy",
          lambda: write_ok(Dataset.write(f"{tmp.name}/lineitem", parts, device=CUDA), tb))
    ds = Dataset.open(f"{tmp.name}/lineitem", device=CUDA)
    mb = sum(os.path.getsize(f"{tmp.name}/lineitem/{f}") for f in os.listdir(f"{tmp.name}/lineitem")) / 1e6
    print(f"[main] lineitem dataset: {mb:.1f} MB written in {PARTITIONS} partitions + manifest "
          f"(l_orderkey, l_quantity, l_suppkey raw: {LINEITEM_N * 16 / 1e6:.1f} MB)")
    ok, qty, supp = (tb.li[nm].values for nm in ("l_orderkey", "l_quantity", "l_suppkey"))
    q25 = int(ok[LINEITEM_N // 4])
    plan = ds._plan([("l_orderkey", "lt", q25)])
    print(f"[main] lineitem dataset _plan(l_orderkey lt {q25}, its 25th percentile): {plan}")
    check([v for _, v in plan[1:]] == ["skip"] * (PARTITIONS - 1), "partitions 2-4 skip")
    drive(f"lineitem dataset count(l_orderkey lt {q25})", "Dataset.count(device=cuda) vs NumPy",
          lambda: ds.count(("l_orderkey", "lt", q25)) == int((ok < q25).sum()))
    host_only("lineitem dataset agg(l_orderkey, min/max)", "Dataset.agg from the manifest zones vs NumPy",
              lambda: ds.agg("l_orderkey", "min") == int(ok.min()) and ds.agg("l_orderkey", "max") == int(ok.max()))
    skeys = np.unique(supp)
    codes = np.searchsorted(skeys, supp)
    want = (np.bincount(codes, minlength=skeys.size), np.bincount(codes, weights=qty, minlength=skeys.size).astype(np.int64))
    drive("lineitem dataset groupby(l_suppkey, l_quantity, (count, sum))", "Dataset.groupby(device=cuda) vs NumPy",
          lambda: (lambda r: np.array_equal(r.keys, skeys) and np.array_equal(r.count, want[0])
                   and np.array_equal(r.sum, want[1]))(ds.groupby("l_suppkey", "l_quantity", ("count", "sum"))),
          ("lmp_unpack",))
    k = int(ok[LINEITEM_N // 1000])
    drive("lineitem dataset select (0.1%)", "Dataset.select(device=cuda) vs NumPy",
          lambda: (lambda r: np.array_equal(r["l_quantity"], qty[ok < k]) and np.array_equal(r["l_suppkey"], supp[ok < k]))(
              ds.select(["l_quantity", "l_suppkey"], ("l_orderkey", "lt", k))))

    def compacted() -> bool:
        t0 = time.perf_counter()
        ds.compact(f"{tmp.name}/compact", rows_per_partition=LINEITEM_N // 2)
        torch.cuda.synchronize()
        ONE_RUN_MS["lineitem dataset compact to 2 partitions"] = (time.perf_counter() - t0) * 1e3
        again = Dataset.open(f"{tmp.name}/compact", device=CUDA)
        return (again.n_partitions == 2 and len(again) == LINEITEM_N
                and again.count(("l_orderkey", "lt", q25)) == int((ok < q25).sum())
                and again.agg("l_quantity", "sum") == int(qty.astype(np.int64).sum()))

    drive("lineitem dataset compact to 2 partitions, reopened", "Dataset.compact(device=cuda) + open vs NumPy",
          compacted)


def write_ok(ds, tb: Tables) -> bool:
    size = LINEITEM_N // PARTITIONS
    for p, part in enumerate(ds.manifest["partitions"]):
        for nm in ("l_orderkey", "l_quantity", "l_suppkey"):
            v = tb.li[nm].values[p * size : (p + 1) * size]
            if part["zones"][nm] != [int(v.min()), int(v.max())] or part["rows"] != size:
                return False
    return True


def peak_mib(fn) -> tuple[object, float]:
    """fn()'s result and the card memory it allocated at its peak, MiB
    above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


PEAKS: dict[str, float] = {}


def stream_main_path(tb: Tables, drive) -> None:
    """Streamed scans of the 1 GiB configs[0] column (count at two chunk
    sizes, the whole column back to the host) and of the wide l_orderkey,
    each with its peak card memory beside the whole-column decode's."""
    v0, c0 = tb.c0
    want = int((v0 < 256).sum())
    _, PEAKS["whole-column decode of configs[0]"] = peak_mib(lambda: gtt.decode(c0, device=CUDA))
    _, PEAKS["whole-column count_where of configs[0]"] = peak_mib(lambda: query.count_where(c0, "lt", 256, device=CUDA))
    chunk_packed = c0.nbytes_compressed / num_groups(c0.n)
    for cg in (64, 4096):
        got = []
        drive(f"configs[0] stream_count_where lt 256, chunk_groups={cg}",
              "stream.stream_count_where(device=cuda) vs count_where and NumPy",
              lambda: got.append(peak_mib(lambda: stream.stream_count_where(c0, "lt", 256, chunk_groups=cg, device=CUDA)))
              or got[0][0] == want == query.count_where(c0, "lt", 256, device=CUDA), ("filter_fold",))
        peak = PEAKS[f"stream_count_where chunk_groups={cg}"] = got[0][1]
        bound_mib = (stream.COUNT_DEPTH + 2) * cg * (chunk_packed + GROUP / 8) / 2**20
        check(peak <= bound_mib, f"stream_count_where chunk_groups={cg}: peak {peak:.1f} MiB > {bound_mib:.1f} MiB")
    got = []
    drive("configs[0] decode_streamed, chunk_groups=64", "stream.decode_streamed(device=cuda) vs the input",
          lambda: got.append(peak_mib(lambda: stream.decode_streamed(c0, chunk_groups=64, device=CUDA)))
          or same_bits(got[0][0], v0), ("lmp_unpack",))
    peak = PEAKS["decode_streamed chunk_groups=64"] = got[0][1]
    bound_mib = (stream.DECODE_DEPTH + 2) * 64 * (chunk_packed + GROUP * 4) / 2**20
    check(peak <= bound_mib, f"decode_streamed: peak {peak:.1f} MiB > {bound_mib:.1f} MiB")
    ok, okc = tb.li["l_orderkey"].values, tb.lineitem["l_orderkey"]
    got = []
    drive("lineitem l_orderkey (wide) stream_decode, chunk_groups=64", "stream.stream_decode(device=cuda) vs the input",
          lambda: got.append(peak_mib(lambda: np.concatenate(list(stream.stream_decode(okc, chunk_groups=64, device=CUDA)))))
          or same_bits(got[0][0], ok), ("delta_decode", "lmp_unpack"))
    PEAKS["wide l_orderkey stream_decode chunk_groups=64"] = got[0][1]
    _, PEAKS["whole-column decode of l_orderkey"] = peak_mib(lambda: gtt.decode(okc, device=CUDA))
    for label, mib in PEAKS.items():
        print(f"[memory] {label}: peak {mib:.1f} MiB of card memory above the resident columns "
              f"(torch.cuda.max_memory_allocated after reset_peak_memory_stats)")
    torch.cuda.empty_cache()


def advisor_main_path(tb: Tables, drive) -> None:
    """suggest(measure=True) on the configs[1] timestamps and the configs[3]
    flags (their near-ties timed on the card), and encode(v, "auto") against
    encode(v, top pick), byte for byte."""
    from giddy_tpu_torch import advisor

    for label, (v, _) in (("configs[1] timestamps", tb.ts), ("configs[3] flags", tb.flags)):
        ranked, measured = advisor.suggest(v), []
        ties = sum(r >= ranked[0][1] * 0.9 for _, r in ranked)  # suggest's tie_tol: the near-ties it times
        (drive if ties > 1 else host_only)(
            f"advisor.suggest({label}, measure=True), {ties} near-tied", "its ranking holds the static one's ratios",
            lambda: measured.append(advisor.suggest(v, measure=True, device=CUDA)) or dict(measured[0]) == dict(ranked))
        print(f"[main] advisor {label}: static {[(s, round(r, 2)) for s, r in ranked[:5]]}; measured on the card "
              f"{[(s, round(r, 2)) for s, r in measured[0][:5]]}")
        host_only(f"encode({label}, 'auto')", f"container bytes == encode(v, {ranked[0][0]!r})'s",
                  lambda: gtt.container_bytes([gtt.encode(v, "auto", name="c")])
                  == gtt.container_bytes([gtt.encode(v, ranked[0][0], name="c")]))
        host_only(f"encode_best({label}, measured ranking)", f"container bytes == encode(v, {measured[0][0][0]!r})'s",
                  lambda: gtt.container_bytes([advisor.encode_best(v, name="c", ranked=measured[0])])
                  == gtt.container_bytes([gtt.encode(v, measured[0][0][0], name="c")]))


def cli_run(argv: list) -> tuple[str, int]:
    """cli.main(argv) in this process: its standard output and exit code."""
    from giddy_tpu_torch import cli

    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code
    return out.getvalue(), code


def cli_main_path(drive) -> None:
    """giddy-tpu-torch's subcommands in a temporary directory on a
    2^22 + 999 column, each output held against the library call's."""
    from giddy_tpu_torch import cli  # noqa: F401  (imported before the calls are timed)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        n = str(CLI_N)
        host_only("cli gen dict / gen nbit", "the .npy files vs datagen.gen_column",
                  lambda: cli_run(["gen", "dict", "--n", n, "--seed", "7", "--out", f"{d}/k.npy"])[1] == 0
                  and cli_run(["gen", "nbit", "--n", n, "--seed", "8", "--out", f"{d}/v.npy"])[1] == 0
                  and np.array_equal(np.load(f"{d}/k.npy"), gen_column("dict", CLI_N, np.random.default_rng(7)))
                  and np.array_equal(np.load(f"{d}/v.npy"), gen_column("nbit", CLI_N, np.random.default_rng(8))))
        k, v = np.load(f"{d}/k.npy"), np.load(f"{d}/v.npy")
        host_only("cli encode auto", "the container vs encode(v, 'auto')",
                  lambda: cli_run(["encode", f"{d}/v.npy", "auto", "--out", f"{d}/v.gtp"])[1] == 0
                  and open(f"{d}/v.gtp", "rb").read() == gtt.container_bytes([gtt.encode(v, "auto", name="col")]))
        host_only("cli pack", "the container vs encode of each column",
                  lambda: cli_run(["pack", f"k=dict:{d}/k.npy", f"v=nbit:{d}/v.npy", "--out", f"{d}/t.gtp"])[1] == 0
                  and open(f"{d}/t.gtp", "rb").read() == gtt.container_bytes(
                      [gtt.encode(k, "dict", name="k"), gtt.encode(v, "nbit", name="v")]))
        cols = gtt.open_container(f"{d}/t.gtp")
        host_only("cli info", "one JSON line a column, schemes and sizes vs the container",
                  lambda: [(j["name"], j["scheme"], j["compressed_bytes"]) for j in map(
                      json.loads, cli_run(["info", f"{d}/t.gtp"])[0].splitlines())]
                  == [(c.name, c.scheme, c.nbytes_compressed) for c in cols])
        drive("cli decode --column 1", "the .npy vs the input",
              lambda: cli_run(["decode", f"{d}/t.gtp", "--column", "1", "--out", f"{d}/d.npy"])[1] == 0
              and np.array_equal(np.load(f"{d}/d.npy"), v), ("lmp_unpack",))
        drive("cli validate", "BIT-EXACT for both columns, exit code 0",
              lambda: (lambda r: r[1] == 0 and r[0].count("BIT-EXACT") == 2)(cli_run(["validate", f"{d}/t.gtp"])))
        drive("cli query --column 1 --op lt --value 256", "the count vs query.count_where and NumPy",
              lambda: json.loads(cli_run(["query", f"{d}/t.gtp", "--column", "1", "--op", "lt", "--value", "256"])[0])[
                  "count"] == int((v < 256).sum()), ("filter_fold",))
        r = groupby.group_reduce(cols[0], cols[1], ("count", "sum"), device=CUDA)
        drive("cli groupby --keys 0 --vals 1 --aggs count,sum", "the rows vs groupby.group_reduce",
              lambda: [json.loads(x) for x in cli_run(["groupby", f"{d}/t.gtp", "--keys", "0", "--vals", "1", "--aggs",
                                                       "count,sum"])[0].splitlines()]
              == [{"key": key.item(), "count": int(c), "sum": s.item()} for key, c, s in zip(r.keys, r.count, r.sum)])
        drive("cli agg sum --column 1", "the value vs NumPy",
              lambda: json.loads(cli_run(["agg", f"{d}/t.gtp", "sum", "--column", "1"])[0])["value"]
              == int(v.astype(np.int64).sum()), ("agg_fold",))
    ONE_RUN_MS[f"cli: gen x2, encode auto, pack, info, decode, validate, query, groupby, agg at n={CLI_N}"] = (
        time.perf_counter() - t0) * 1e3


SELFTEST: list = []
ONE_RUN_MS: dict[str, float] = {}  # calls timed once, where the main path drove them


def selftest_main_path(drive) -> None:
    """The port's selftest at 2^22 + 999 on the card: every core scheme and
    check exact; its JSON line printed, then each core scheme's traffic
    audit (its decoder's temporary bytes and traffic ratios) on a line
    beside the cap. The run fails unless the selftest's traffic gate
    passed: every traffic_vs_sol at or under TRAFFIC_CAP."""
    from giddy_tpu_torch import selftest

    t0 = time.perf_counter()
    drive(f"selftest.run_selftest({SELFTEST_N})", "every scheme and check exact",
          lambda: SELFTEST.append(selftest.run_selftest(SELFTEST_N, device=CUDA)) or SELFTEST[-1]["pass"])
    ONE_RUN_MS[f"selftest.run_selftest({SELFTEST_N}), with its checks"] = (time.perf_counter() - t0) * 1e3
    report = SELFTEST[-1]
    print(json.dumps(report))
    for scheme in selftest.SCHEMES:
        e = report["schemes"][scheme]
        print(f"[audit] {scheme}: temp_bytes {e['temp_bytes']}, traffic_vs_ideal {e['traffic_vs_ideal']}, "
              f"traffic_vs_sol {e['traffic_vs_sol']} (cap {selftest.TRAFFIC_CAP})")
        check(isinstance(e["temp_bytes"], int), f"{scheme}: the selftest's traffic audit did not run on the card")
    print(f"[audit] traffic_ok {report.get('traffic_ok')} (every traffic_vs_sol <= {selftest.TRAFFIC_CAP})")
    check(report.get("traffic_ok") is True,
          f"the selftest's traffic gate: traffic_ok {report.get('traffic_ok')}, cap {selftest.TRAFFIC_CAP}")


def time_tables(tb: Tables, smi: str) -> None:
    """Phase 5 for the tables phase: each call's host-clock ms, the median
    of 10 (3 where a host step takes seconds; 1 for the left join, the
    anti-join and the dataset's write; compact's is the main path's one
    run), beside the raw H2D of the values it reads."""
    from giddy_tpu_torch import advisor
    from giddy_tpu_torch.dataset import Dataset

    def h2d(a: np.ndarray) -> float:
        host = np.ascontiguousarray(a).view(np.uint8)
        return host_ms(lambda: torch.from_numpy(host).to(CUDA))

    # strings as fixed-width bytes (ASCII here)
    raw = {nm: h2d(np.array(a.tolist(), dtype="S") if a.dtype == object else a) for nm, a in tb.cust.items()}
    raw.update({nm: h2d(c.values) for nm, c in tb.li.items()})
    raw.update({nm: h2d(c.values if c.vocab is None else np.array([s.encode() for s in c.vocab], dtype="S")[c.idx])
                for nm, c in tb.od.items()})
    raw["configs[0]"] = h2d(tb.c0[0])
    raw["configs[1]"] = h2d(tb.ts[0])
    raw["configs[3]"] = h2d(tb.flags[0])
    customer, orders, lineitem = tb.customer, tb.orders, tb.lineitem
    building = customer.filter(("c_mktsegment", "eq", "BUILDING"))
    ok = tb.li["l_orderkey"].values
    k, q25 = int(ok[LINEITEM_N // 1000]), int(ok[LINEITEM_N // 4])
    ds = Dataset.open(f"{DATASET_DIR[0].name}/lineitem", device=CUDA)
    c0 = tb.c0[1]
    cells = [
        ("customer Table.from_arrays (advisor + host encode)", lambda: gtt.Table.from_arrays(tb.cust, device=CUDA), 3,
         list(tb.cust)),
        ("orders.semi_join(o_custkey, customer)", lambda: orders.semi_join("o_custkey", customer, "c_custkey"), 3,
         ["o_custkey", "c_custkey"]),
        ("customer.filter(c_mktsegment eq BUILDING)", lambda: customer.filter(("c_mktsegment", "eq", "BUILDING")), 3,
         list(tb.cust)),
        ("orders.semi_join(o_custkey, BUILDING)", lambda: orders.semi_join("o_custkey", building, "c_custkey"), 3,
         ["o_custkey", "c_custkey"]),
        ("customer.anti_join(c_custkey, orders)", lambda: customer.anti_join("c_custkey", orders, "o_custkey"), 1,
         ["o_custkey", "c_custkey"]),
        ("join_indices(o_custkey, BUILDING c_custkey, inner)",
         lambda: gtt.join_indices(orders["o_custkey"], building["c_custkey"], device=CUDA), 3, ["o_custkey", "c_custkey"]),
        ("join_indices(..., left)", lambda: gtt.join_indices(orders["o_custkey"], building["c_custkey"], how="left",
                                                             device=CUDA), 1, ["o_custkey", "c_custkey"]),
        ("orders.join(BUILDING, other_select=[c_mktsegment, c_acctbal])",
         lambda: orders.join("o_custkey", building, "c_custkey", select=["o_custkey", "o_orderpriority"],
                             other_select=["c_mktsegment", "c_acctbal"]), 3,
         ["o_custkey", "o_orderpriority", "c_custkey", "c_mktsegment", "c_acctbal"]),
        ("customer.count(BUILDING, c_nationkey lt 5)",
         lambda: customer.count(("c_mktsegment", "eq", "BUILDING"), ("c_nationkey", "lt", 5)), 10,
         ["c_mktsegment", "c_nationkey"]),
        ("customer.where_any(MACHINERY, c_nationkey eq 24)",
         lambda: customer.where_any(("c_mktsegment", "eq", "MACHINERY"), ("c_nationkey", "eq", 24)), 10,
         ["c_mktsegment", "c_nationkey"]),
        ("lineitem.agg(l_quantity, sum)", lambda: lineitem.agg("l_quantity", "sum"), 10, ["l_quantity"]),
        ("lineitem.agg(l_quantity, distinct)", lambda: lineitem.agg("l_quantity", "distinct"), 10, ["l_quantity"]),
        ("lineitem.agg(l_extendedprice, sum)", lambda: lineitem.agg("l_extendedprice", "sum"), 10, ["l_extendedprice"]),
        ("orders.groupby(o_orderpriority, o_custkey, (count, sum))",
         lambda: orders.groupby("o_orderpriority", "o_custkey", ("count", "sum")), 10, ["o_orderpriority", "o_custkey"]),
        ("lineitem.select([l_quantity, l_suppkey], 0.1%)",
         lambda: lineitem.select(["l_quantity", "l_suppkey"], lineitem.where("l_orderkey", "lt", k)), 3,
         ["l_orderkey", "l_quantity", "l_suppkey"]),
        ("orders.top_k(o_custkey, 10, select=[o_clerk, o_orderpriority])",
         lambda: orders.top_k("o_custkey", 10, select=["o_clerk", "o_orderpriority"]), 10, ["o_custkey"]),
        ("customer.sort_by([c_nationkey, c_acctbal])", lambda: customer.sort_by(["c_nationkey", "c_acctbal"]), 3,
         list(tb.cust)),
        ("lineitem dataset _plan (l_orderkey lt q25)", lambda: ds._plan([("l_orderkey", "lt", q25)]), 10, []),
        ("lineitem dataset count(l_orderkey lt q25)", lambda: ds.count(("l_orderkey", "lt", q25)), 10, ["l_orderkey"]),
        ("lineitem dataset agg(l_orderkey, min) (manifest)", lambda: ds.agg("l_orderkey", "min"), 10, []),
        ("lineitem dataset groupby(l_suppkey, l_quantity)", lambda: ds.groupby("l_suppkey", "l_quantity", ("count", "sum")),
         3, ["l_suppkey", "l_quantity"]),
        ("lineitem dataset select 0.1%", lambda: ds.select(["l_quantity", "l_suppkey"], ("l_orderkey", "lt", k)), 3,
         ["l_orderkey", "l_quantity", "l_suppkey"]),
        ("configs[0] count_where lt 256 (whole column)", lambda: query.count_where(c0, "lt", 256, device=CUDA), 10,
         ["configs[0]"]),
        ("configs[0] stream_count_where lt 256, chunk_groups=64",
         lambda: stream.stream_count_where(c0, "lt", 256, chunk_groups=64, device=CUDA), 3, ["configs[0]"]),
        ("configs[0] stream_count_where lt 256, chunk_groups=4096",
         lambda: stream.stream_count_where(c0, "lt", 256, chunk_groups=4096, device=CUDA), 3, ["configs[0]"]),
        ("configs[0] decode(col) to the host (whole column)", lambda: gtt.decode(c0, device=CUDA).cpu(), 3, ["configs[0]"]),
        ("configs[0] decode_streamed, chunk_groups=64", lambda: stream.decode_streamed(c0, chunk_groups=64, device=CUDA), 3,
         ["configs[0]"]),
        ("l_orderkey (wide) stream_decode, chunk_groups=64",
         lambda: list(stream.stream_decode(tb.lineitem["l_orderkey"], chunk_groups=64, device=CUDA)), 3, ["l_orderkey"]),
        ("advisor.suggest(configs[1] timestamps, measure=True)",
         lambda: advisor.suggest(tb.ts[0], measure=True, device=CUDA), 3, []),
        ("advisor.suggest(configs[3] flags, measure=True)", lambda: advisor.suggest(tb.flags[0], measure=True,
                                                                                    device=CUDA), 3, []),
        ("encode(configs[1] timestamps, 'auto')", lambda: gtt.encode(tb.ts[0], "auto"), 3, ["configs[1]"]),
    ]
    for what, fn, runs, reads in cells:
        ms = host_ms(fn, runs=runs, warmup=1 if runs == 10 else 0)
        print(f"[time] tables {what} on {smi}: {ms:.3f} ms (host clock, median of {runs}); "
              f"H2D of the raw {'+'.join(reads) if reads else 'nothing'} {sum(raw[r] for r in reads):.3f} ms")
    with tempfile.TemporaryDirectory() as d:
        parts = lineitem_partitions(tb)
        ms = host_ms(lambda: Dataset.write(f"{d}/w", parts, device=CUDA), runs=1, warmup=0)
        print(f"[time] tables lineitem Dataset.write, 4 partitions (zones on the card) on {smi}: {ms:.3f} ms (host "
              f"clock, one run); H2D of the raw l_orderkey+l_quantity+l_suppkey "
              f"{raw['l_orderkey'] + raw['l_quantity'] + raw['l_suppkey']:.3f} ms")
    for what, ms in ONE_RUN_MS.items():
        print(f"[time] tables {what} on {smi}: {ms:.3f} ms (host clock, one run)")
    torch.cuda.empty_cache()


# -- the dist phase ---------------------------------------------------------------
# The sharded layer on the card (dist.py, dist_query.py, mesh= of joins and
# datasets): every shard runs the single-GPU decoder or scan of its group
# slice, so a mesh that lists the card four times, dist.Mesh([cuda:0] * 4),
# launches each kernel once a shard. Every result is exact against NumPy; a
# two-rank gloo drill on the card checks each rank's shards and an
# all-reduced count.

DIST_SHARDS = 4
DRILL_N = 2**24
DRILL_SCHEMES = ("nbit", "dict", "rle", "patched")
DRILL_KERNELS = {"nbit": "lmp_unpack", "dict": "dict_decode", "rle": "run_expand", "patched": "patched_decode"}


def dist_meshes() -> dict:
    """The phase's meshes: every visible card, and the card four times."""
    from giddy_tpu_torch import dist

    return {"default_mesh()": dist.default_mesh(), f"Mesh([cuda:0] * {DIST_SHARDS})":
            dist.Mesh([torch.device("cuda", 0)] * DIST_SHARDS)}


def per_shard(label: str, launched: dict, want: dict) -> None:
    """The [dist] line of a sharded call: its launches equal ``want``."""
    check(launched == want, f"{label}: launched {launched}, want {want}")
    print(f"[dist] {label}: exact; launches {launched}, once a shard as the single-GPU call's")


def twin_launches(fn) -> dict[str, int]:
    """The launches of a single-GPU twin ``fn()``, counted from a reset:
    what a sharded call launches once a shard."""
    kernels.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: c for k, c in kernels.launches().items() if c}


@contextlib.contextmanager
def counted_prunes():
    """Counts, into the dict it yields, the launches made inside
    join._match_bitmap (a join's two prunes) while the block runs."""
    from giddy_tpu_torch import join

    inner, pruned = join._match_bitmap, {}

    def counted(*args, **kwargs):
        before = kernels.launches()
        out = inner(*args, **kwargs)
        for k, c in kernels.launches().items():
            if c > before[k]:
                pruned[k] = pruned.get(k, 0) + c - before[k]
        return out

    join._match_bitmap = counted
    try:
        yield pruned
    finally:
        join._match_bitmap = inner


def dist_main_path(tb: Tables, container: list, drive) -> None:
    """The dist phase's paths, each driven once with the launch counts reset
    and read around it, exact against NumPy, its launches checked against
    the single-GPU call's times the shard count."""
    from giddy_tpu_torch import dist, dist_query
    from giddy_tpu_torch.dataset import Dataset

    t0 = time.perf_counter()
    meshes = dist_meshes()
    cols = [col for _, col in container]
    kernels.reset_launches()
    gtt.decode_columns(cols, device=CUDA)
    torch.cuda.synchronize()
    single = {k: c for k, c in kernels.launches().items() if c}

    def columns_ok(mesh) -> bool:
        outs = dist.decode_columns_sharded(cols, mesh)
        return sorted(outs) == sorted(c.name for c in cols) and all(same_on_card(outs[c.name], v) for v, c in container)

    for label, mesh in meshes.items():
        name = f"configs[4] decode_columns_sharded on {label}"
        per_shard(name, drive(name, "dist.decode_columns_sharded vs inputs", lambda: columns_ok(mesh)),
                  {k: c * mesh.size for k, c in single.items()})
    four = meshes[f"Mesh([cuda:0] * {DIST_SHARDS})"]
    v0, c0 = tb.c0
    for name, fn, want, kernel in (
            ("count_where_sharded(configs[0], lt, 256)", lambda: dist_query.count_where_sharded(c0, "lt", 256, four),
             int((v0 < 256).sum()), "filter_fold"),
            ("sum_sharded(configs[0])", lambda: dist_query.sum_sharded(c0, four), int(v0.sum(dtype=np.int64)),
             "agg_fold"),
            ("min_sharded(configs[0])", lambda: dist_query.min_sharded(c0, four), int(v0.min()), "agg_fold")):
        per_shard(name, drive(name, f"dist_query on {four!r} vs NumPy", lambda: fn() == want),
                  {kernel: DIST_SHARDS})
    supp, qty = tb.li["l_suppkey"], tb.li["l_quantity"]
    skeys = np.unique(supp.values)
    want_g = group_oracle(np.searchsorted(skeys, supp.values), qty.values, skeys.shape[0], 51)
    name = "group_reduce_sharded(l_suppkey, l_quantity, (count, sum, min, max))"
    per_shard(name, drive(name, "dist_query.group_reduce_sharded vs NumPy", lambda: same_group(
        dist_query.group_reduce_sharded(supp.col, qty.col, AGGS, mesh=four), skeys, want_g)),
        {"lmp_unpack": 2 * DIST_SHARDS})
    ok = tb.li["l_orderkey"]
    want = {k: c * DIST_SHARDS for k, c in twin_launches(lambda: aggregate.sum_(ok.col, device=CUDA)).items()}
    per_shard("sum_sharded(l_orderkey, wide)", drive("sum_sharded(l_orderkey, wide)", "dist_query.sum_sharded vs NumPy",
              lambda: dist_query.sum_sharded(ok.col, four) == int(ok.values.sum(dtype=np.int64))), want)
    cust, customer, orders = tb.cust, tb.customer, tb.orders
    building = customer.filter(("c_mktsegment", "eq", "BUILDING"))
    bkeys = cust["c_custkey"][cust["c_mktsegment"] == "BUILDING"]
    li_w, ri_w = join_pairs(tb.od["o_custkey"].values, bkeys, "inner")

    def join_ok(mesh) -> bool:
        r = orders.join("o_custkey", building, "c_custkey", select=["o_custkey"], other_select=[], mesh=mesh)
        return np.array_equal(r[1], li_w) and np.array_equal(r[2], ri_w)

    # the two prunes run once a shard; the key takes and the host merge after them stay on one device
    with counted_prunes() as pruned:
        total = twin_launches(lambda: check(join_ok(None), "orders.join(BUILDING): the single-GPU twin is wrong"))
    prune_one, rest_one = dict(pruned), {k: c - pruned.get(k, 0) for k, c in total.items() if c > pruned.get(k, 0)}
    name = f"orders.join(BUILDING, mesh={four!r})"
    with counted_prunes() as pruned:
        launched = drive(name, "Table.join(mesh=...) pairs vs a NumPy sort-merge", lambda: join_ok(four))
    prune_four = dict(pruned)
    rest_four = {k: c - pruned.get(k, 0) for k, c in launched.items() if c > pruned.get(k, 0)}
    check(bool(prune_one) and rest_four == rest_one
          and prune_four == {k: c * DIST_SHARDS for k, c in prune_one.items()},
          f"{name}: prunes launched {prune_four}, the rest {rest_four}; single-GPU prunes {prune_one}, rest {rest_one}")
    print(f"[dist] orders.join(BUILDING, mesh=...): exact, {li_w.size} pairs; launches {launched}: the prunes "
          f"{prune_four}, once a shard as the single-GPU call's {prune_one}, the key takes {rest_four} as its")
    ds = Dataset.open(f"{DATASET_DIR[0].name}/lineitem", device=CUDA)
    q25 = int(ok.values[LINEITEM_N // 4])
    want_n = int((ok.values < q25).sum())
    want = {k: c * DIST_SHARDS for k, c in twin_launches(lambda: check(
        ds.count(("l_orderkey", "lt", q25)) == want_n, "lineitem dataset count: the single-GPU twin is wrong")).items()}
    name = f"lineitem dataset count(l_orderkey lt {q25}, mesh=...)"
    per_shard(name, drive(name, "Dataset.count(mesh=...) vs NumPy",
                          lambda: ds.count(("l_orderkey", "lt", q25), mesh=four) == want_n), want)
    dist_query._ARGS_CACHE.clear()
    torch.cuda.empty_cache()
    print(f"[dist] the phase's main paths: {time.perf_counter() - t0:.1f} s")


def drill_worker(rank: int, port: int, results) -> None:
    """One rank of the two-rank drill on cuda:0: torch.distributed over
    gloo, host_chip_mesh(2, 2) of the one card, so two shards a rank. Each
    rank checks its shards of an nbit, dict, rle and patched column at
    2^24 against the input on the card, with two launches of the column's
    kernel, and one count all-reduced across the ranks."""
    import torch.distributed as tdist

    from giddy_tpu_torch import dist, dist_query

    try:
        torch.cuda.set_device(0)
        tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
        mesh, axes = dist.host_chip_mesh(2, 2, [torch.device("cuda", 0)] * 4)
        lines = []
        for i, scheme in enumerate(DRILL_SCHEMES):
            v = gen_column(scheme, DRILL_N, np.random.default_rng(40 + i))
            col = gtt.encode(v, scheme, name=f"drill_{scheme}")
            fn, args = dist.build_sharded_decoder(col, mesh, axes)
            kernels.reset_launches()
            outs = fn(*args)
            torch.cuda.synchronize()
            launched = {k: c for k, c in kernels.launches().items() if c}
            check(launched == {DRILL_KERNELS[scheme]: 2}, f"drill {scheme} rank {rank}: launched {launched}")
            for g0, u in outs:
                rows = min(col.n - g0 * GROUP, u.numel())
                check(same_on_card(u[:rows].view(torch.int32), v[g0 * GROUP : g0 * GROUP + rows].view(np.int32)),
                      f"drill {scheme} rank {rank} shard at group {g0}")
            lines.append(f"{scheme} groups {[g0 for g0, _ in outs]} exact, launches {launched}")
            if scheme == "nbit":
                count = dist_query.count_where_sharded(col, "lt", int(np.median(v)), mesh, axes)
                check(count == int((v < int(np.median(v))).sum()), f"drill all-reduced count rank {rank}")
                lines.append(f"count_where_sharded all-reduced {count} exact")
        tdist.barrier()
        tdist.destroy_process_group()
        results.put((rank, "; ".join(lines)))
    except BaseException as e:  # the parent reports it and fails
        results.put((rank, f"FAILED: {type(e).__name__}: {e}"))


def dist_drill() -> None:
    """The two-rank gloo drill (drill_worker) in two spawned processes."""
    import multiprocessing
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=drill_worker, args=(r, port, results)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank in (0, 1):
        check(not got[rank].startswith("FAILED") and all(p.exitcode == 0 for p in procs), f"drill rank {rank}: {got[rank]}")
        print(f"[dist] two-rank gloo drill, rank {rank} (2 shards on cuda:0): {got[rank]}")
    print(f"[dist] two-rank gloo drill: passed in {time.perf_counter() - t0:.1f} s (two processes, start-up included)")


def time_dist(tb: Tables, container: list, smi: str) -> None:
    """Phase 5 for the dist phase: each sharded call's host-clock ms beside
    the single-GPU call's (medians of 5 for the decode, 3 for the scans).
    The scans' placements are cached
    (dist_query), so each sharded scan is timed with its cache kept and
    with it cleared before every run (placed anew, as the single-GPU call
    uploads every time)."""
    from giddy_tpu_torch import dist, dist_query
    from giddy_tpu_torch.dataset import Dataset

    t0 = time.perf_counter()
    meshes = dist_meshes()
    cols = [col for _, col in container]
    one = host_ms(lambda: gtt.decode_columns(cols, device=CUDA), runs=5)
    for label, mesh in meshes.items():
        ms = host_ms(lambda: dist.decode_columns_sharded(cols, mesh), runs=5)
        print(f"[time] dist configs[4] 4 x 2^26 decode_columns_sharded on {label} on {smi}: {ms:.3f} ms; "
              f"single-GPU decode_columns {one:.3f} ms (host clock, medians of 5)")
    c0 = tb.c0[1]
    ok, supp, qty = tb.li["l_orderkey"].col, tb.li["l_suppkey"].col, tb.li["l_quantity"].col
    customer, orders = tb.customer, tb.orders
    building = customer.filter(("c_mktsegment", "eq", "BUILDING"))
    ds = Dataset.open(f"{DATASET_DIR[0].name}/lineitem", device=CUDA)
    q25 = int(tb.li["l_orderkey"].values[LINEITEM_N // 4])
    cells = [
        ("count_where configs[0] lt 256", lambda m: dist_query.count_where_sharded(c0, "lt", 256, m),
         lambda: query.count_where(c0, "lt", 256, device=CUDA)),
        ("sum configs[0]", lambda m: dist_query.sum_sharded(c0, m), lambda: aggregate.sum_(c0, device=CUDA)),
        ("min configs[0]", lambda m: dist_query.min_sharded(c0, m), lambda: aggregate.min_(c0, device=CUDA)),
        ("group_reduce(l_suppkey, l_quantity, 4 aggs)", lambda m: dist_query.group_reduce_sharded(supp, qty, AGGS, mesh=m),
         lambda: groupby.group_reduce(supp, qty, AGGS, device=CUDA)),
        ("sum l_orderkey (wide)", lambda m: dist_query.sum_sharded(ok, m), lambda: aggregate.sum_(ok, device=CUDA)),
        ("orders.join(BUILDING)", lambda m: orders.join("o_custkey", building, "c_custkey", select=["o_custkey"],
                                                        other_select=[], mesh=m),
         lambda: orders.join("o_custkey", building, "c_custkey", select=["o_custkey"], other_select=[])),
        (f"lineitem dataset count(l_orderkey lt {q25})", lambda m: ds.count(("l_orderkey", "lt", q25), mesh=m),
         lambda: ds.count(("l_orderkey", "lt", q25))),
    ]
    for what, sharded, single in cells:
        one = host_ms(single, runs=3)
        out = []
        for label, mesh in meshes.items():
            kept = host_ms(lambda: sharded(mesh), runs=3)
            anew = host_ms(lambda: (dist_query._ARGS_CACHE.clear(), sharded(mesh)), runs=3)
            out.append(f"on {label} {kept:.3f} ms placements cached, {anew:.3f} ms placed anew")
        print(f"[time] dist {what} on {smi}: sharded {'; '.join(out)}; single-GPU {one:.3f} ms "
              f"(host clock, medians of 3)")
    dist_query._ARGS_CACHE.clear()
    torch.cuda.empty_cache()
    print(f"[time] dist: the phase's timings took {time.perf_counter() - t0:.1f} s")


# -- the examples phase ------------------------------------------------------------
# The repo's two examples as a user runs them on the card: each one's main at
# the reference's default size, its own asserts the check (an assert that
# fails ends the run), its printed lines, launches and host-clock wall time.

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
# example -> (its main's size: the reference example's default, its last line when every assert passed)
EXAMPLES = {
    "compression_tour_torch": (20, "all schemes decoded bit-exact vs the oracle"),
    "tpch_demo_torch": (1 << 20, "ALL DEMO CHECKS PASSED"),
}


def load_script(path: str, name: str):
    """The script at ``path`` as a module named ``name``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_example(name: str):
    """examples/<name>.py as a module."""
    return load_script(os.path.join(EXAMPLES_DIR, f"{name}.py"), f"examples.{name}")


def decoders_of(cols: list) -> set[str]:
    """The KERNELS rows that decode each column in its prep's form: a
    strdict column's through its codes column, a cascade column's through
    the LUT stage and its inner kernel; a raw column launches none."""
    names = set()
    for col in cols:
        col = strings.codes_column(col) if col.scheme == "strdict" else col
        if col.scheme != "raw":
            name, _ = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), gtt.narrow_store_dtype(col))
            names.update([name, "cascade_lut"] if col.scheme == "cascade" else [name])
    return names


def examples_main_path(drive, smi: str) -> None:
    """Each example's main(size, device=cuda) through drive. The kernels it
    must launch come from its own inputs, encoded here as it encodes them:
    the tour's sixteen columns (the decode kernel of every scheme but raw),
    and the demo's orders table (the decoders of its four columns, K16 for
    its predicates and K17 for its aggregates), whose schemes must be the
    ones the demo prints."""
    tour, demo = (load_example(name) for name in EXAMPLES)
    log2_n, n = EXAMPLES["compression_tour_torch"][0], EXAMPLES["tpch_demo_torch"][0]
    rng = np.random.default_rng(7)
    tour_cols = [gtt.encode(gen_column(scheme, 1 << log2_n, rng), scheme) for scheme in tour.SCHEMES]
    date, cust, total, status = demo.orders_arrays(n, np.random.default_rng(42))
    orders = gtt.Table.from_arrays({"date": date, "cust": cust, "total": total, "status": status}, device="cpu")
    expect = {"compression_tour_torch": decoders_of(tour_cols),
              "tpch_demo_torch": decoders_of([orders[nm] for nm in orders.names]) | {"filter_fold", "agg_fold"}}
    for name, mod in (("compression_tour_torch", tour), ("tpch_demo_torch", demo)):
        size, last = EXAMPLES[name]
        out, wall = io.StringIO(), []

        def run() -> bool:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mod.main(size, device=CUDA)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            return out.getvalue().splitlines()[-1] == last

        launched = drive(f"examples/{name}.py main({size}, device=cuda)", f"main's asserts passed and its last line {last!r} is",
                         run, expect=tuple(sorted(expect[name])))
        lines = out.getvalue().splitlines()
        for line in lines:
            print(f"[examples] {name}| {line}")
        if name == "tpch_demo_torch":
            printed = next(line for line in lines if line.startswith("schemes: "))
            want = {nm: orders[nm].scheme for nm in orders.names}
            check(ast.literal_eval(printed[len("schemes: "):]) == want, f"{name}: printed {printed}, encoded {want}")
        print(f"[examples] {name} main({size}, device=cuda) on {smi}: {wall[0]:.3f} s wall (host clock, one run, "
              f"encode and advisor on the host included); {sum(launched.values())} launches {launched}; "
              f"expected at least {sorted(expect[name])}")


# -- the bench phase ----------------------------------------------------------------
# bench_torch.py and scripts/multihost_bench_torch.py as a user runs them on the
# card. Every bench kind's prepared decode goes through drive at 2^20, held bit
# for bit to decode_ref; then bench_torch's main at 2^24 (its trials in fresh
# processes, which load the library this run built) and the multihost script as
# one process and as two gloo ranks on cuda:0, their JSON lines parsed. The
# trials' launches happen in other processes and are not counted.

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH_N = 2**20
BENCH_ARGV = ["--n", "24", "--trials", "1", "--iters", "8", "--no-selftest", "--device", "cuda"]
MULTIHOST_ARGV = ["--n", "22", "--iters", "3", "--device", "cuda:0"]
# the keys of each script's line (bench.py's and scripts/multihost_bench.py's)
BENCH_LINE = ("metric", "value", "unit", "timing_suspect", "vs_baseline")
MULTIHOST_LINE = ("num_hosts", "devices", "n", "schemes")
MULTIHOST_RECORD = ("decode_GBps_slice", "decode_GBps_per_chip", "time_s")


def bench_module():
    return load_script(os.path.join(REPO, "bench_torch.py"), "bench_torch")


def bench_main_path(drive) -> None:
    """Each bench kind through bench_torch's own prepare (prepare_scheme,
    prepare_mixed, prepare_narrow) on the card, one rng in turn, and its
    run() against decode_ref through drive; raw launches no kernel and is
    checked alone."""
    bench = bench_module()
    rng = np.random.default_rng(0)
    for kind in [*bench.ALL, "rle_dense", "xordelta_narrow", "mixed", "narrow"]:
        if kind in ("mixed", "narrow"):
            cols, run = getattr(bench, f"prepare_{kind}")(BENCH_N, rng, CUDA)
        else:
            col, run_one = bench.prepare_scheme(kind, BENCH_N, rng, CUDA)
            cols, run = [col], (lambda: [run_one()])
        wants = [gtt.decode_ref(c) for c in cols]

        def exact() -> bool:
            return all(same_bits(as_numpy(u, c.n, c.dtype), w) for u, c, w in zip(run(), cols, wants))

        label, what = f"bench_torch.py {kind} n={BENCH_N}", "its prepared run() vs decode_ref"
        expect = decoders_of(cols)
        if not expect:
            check(exact(), f"{label}: {what} is wrong")
            print(f"[main] {label}: {what} bit-exact; no kernel (raw)")
            continue
        drive(label, what, exact, expect=tuple(sorted(expect)))


def script_line(stdout: str, keys: tuple, what: str) -> dict:
    """The JSON object on the last line of ``stdout``, which must have every key."""
    lines = stdout.splitlines()
    check(bool(lines), f"{what} printed nothing")
    line = json.loads(lines[-1])
    check(all(k in line for k in keys), f"{what}: line {line} lacks one of {keys}")
    return line


def multihost_line(stdout: str, what: str, hosts: int, devices: int) -> dict:
    line = script_line(stdout, MULTIHOST_LINE, what)
    check((line["num_hosts"], line["devices"]) == (hosts, devices), f"{what}: {line['num_hosts']} hosts, "
          f"{line['devices']} devices, not {hosts}, {devices}")
    check(all(all(k in r for k in MULTIHOST_RECORD) and r["time_s"] > 0 for r in line["schemes"].values()),
          f"{what}: a scheme's record lacks one of {MULTIHOST_RECORD}: {line['schemes']}")
    return line


def bench_gap(bench, smi: str) -> None:
    """The bench's clock against the kernel's, on the very column each
    headline scheme's bench trial times at its default size (a fresh
    default_rng(0)): bench_torch._median_time (the host clock around
    batches of 4 calls through a synchronise), CUDA events around one call
    (median of 20, queued behind a sleep kernel), and the host's time to
    issue one call while a sleep kernel holds the card."""
    n = 1 << 26
    for kind in bench.HEADLINE:
        col, run = bench.prepare_scheme(kind, n, np.random.default_rng(0), CUDA)
        host = bench._median_time(run, 8, [CUDA]) * 1e3
        kernel = cuda_ms(run, queued=True)
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        issue = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(f"[bench] {kind} n=2^26 (bench_torch.py's column) on {smi}: bench clock {host:.4f} ms, kernel "
              f"{kernel:.4f} ms (CUDA events), bench/kernel {host / kernel:.3f}; issue {issue * 1e3:.1f} us a call "
              f"(host clock, the card held)")
        del col, run
    torch.cuda.empty_cache()


def bench_scripts(smi: str) -> None:
    """bench_torch.main(BENCH_ARGV) with its records in a temporary
    directory, then scripts/multihost_bench_torch.py as one process and as
    two gloo ranks on cuda:0. Fails on a missing key, an ops census error
    or a trial that fails (bench_torch raises)."""
    import pathlib
    import socket

    bench = bench_module()
    bench_gap(bench, smi)
    with tempfile.TemporaryDirectory() as d:
        bench.RESULTS = pathlib.Path(d)
        out, t0 = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench.main(BENCH_ARGV)
        wall = time.perf_counter() - t0
        line = script_line(out.getvalue(), BENCH_LINE, "bench_torch.py")
        detail = json.loads((pathlib.Path(d) / "bench_detail.json").read_text())
    check("ops_roofline_error" not in detail, f"bench_torch.py: {detail.get('ops_roofline_error')}")
    check(sorted(detail["ops_roofline"]) == sorted(bench.ALL)
          and not any(r["interpreted"] for r in detail["ops_roofline"].values()),
          "bench_torch.py: the ops table lacks a scheme's SASS census")
    check(line["timing_suspect"] is False, f"bench_torch.py: timing_suspect {line['timing_suspect']} on {smi}")
    for name, r in [*detail["schemes"].items(), ("narrow", detail["narrow"])]:
        sol = f", sol_fraction {r['sol_fraction']:.4f}" if r.get("sol_fraction") is not None else ""
        print(f"[bench] bench_torch.py --n {BENCH_ARGV[1]} {name} on {smi}: {r['decode_GBps']:.3f} GB/s decoded, time_s "
              f"{r['time_s'] * 1e3:.4f} ms (host clock, median of batches of 4), ratio {r['ratio']:.3f}{sol}")
    print(f"[bench] bench_torch.py {' '.join(BENCH_ARGV)} on {smi}: {json.dumps(line)} ({wall:.1f} s wall, "
          f"{len(detail['schemes']) + 1} trials in fresh processes, ops table of {len(detail['ops_roofline'])} schemes)")
    script = os.path.join(REPO, "scripts", "multihost_bench_torch.py")
    t0 = time.perf_counter()
    one = subprocess.run([sys.executable, script, *MULTIHOST_ARGV], capture_output=True, text=True, timeout=600)
    check(one.returncode == 0, f"multihost_bench_torch.py failed:\n{one.stderr[-2000:]}")
    lines = {"one process": (multihost_line(one.stdout, "multihost_bench_torch.py", 1, 1), time.perf_counter() - t0)}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, *MULTIHOST_ARGV, "--coordinator", f"localhost:{port}",
                               "--num-hosts", "2", "--host-id", str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multihost_bench_torch.py rank {rank} of 2 failed:\n{err[-2000:]}")
    check(outs[1][0] == "", f"multihost_bench_torch.py rank 1 printed {outs[1][0]!r}")
    lines["two gloo ranks on cuda:0"] = (multihost_line(outs[0][0], "multihost_bench_torch.py rank 0", 2, 2),
                                         time.perf_counter() - t0)
    for how, (line, wall) in lines.items():
        for scheme, r in line["schemes"].items():
            print(f"[bench] multihost_bench_torch.py {' '.join(MULTIHOST_ARGV)}, {how}, {scheme} on {smi}: "
                  f"{r['decode_GBps_slice']:.3f} GB/s across the slice, {r['decode_GBps_per_chip']:.3f} a shard, "
                  f"time_s {r['time_s'] * 1e3:.4f} ms (host clock, median of {MULTIHOST_ARGV[3]})")
        print(f"[bench] multihost_bench_torch.py, {how}: {line['num_hosts']} host(s), {line['devices']} device(s), "
              f"{wall:.1f} s wall (start-up included)")


def main() -> int:
    smi = environment()
    build()
    v0, vd = configs0_values(), dzbv_values()
    native_phase(v0, vd)
    kernel_checks()
    cols = main_columns(v0)
    x = scan_input()
    container = container_columns()
    casc = cascade_main()
    rank = rank_column()
    epilogue = epilogue_columns()
    dz = dzbv_main(vd)
    scan = scan_columns(cols)
    li, od = lineitem_table(), orders_table()
    analytic_kernel_checks(li, od)
    tables = tables_setup(li, od, cols)
    counts, forms, picked = main_path(cols + epilogue, x, container, casc, rank, [(v, col) for _, v, col in epilogue],
                                      dz, scan, (li, od), tables, smi)
    container_without_sync("configs[4]", container)
    container_without_sync("model + bitmap + alp", [(v, col) for _, v, col in epilogue])
    timings = dict(time_column(label, v, col, smi) for label, v, col in cols + epilogue)
    timings.update([time_scan(x, smi)])
    v, col = container[-1]
    timings.update([time_column("configs[4] patched n=2^26", v, col, smi)])
    timings.update([time_column("cascade rle d=8 n=2^26", *casc, smi)])
    time_container(container, smi)
    rank_timing = rank_cell(rank, smi)
    timings.update(time_dzbv(*dz, picked, smi))
    timings.update(time_scan_layer(scan, smi))
    timings.update(time_encode({label: (v, col) for label, v, col in cols}, smi))
    time_analytic(li, od, smi)
    time_tables(tables, smi)
    dist_drill()
    time_dist(tables, container, smi)
    bench_scripts(smi)
    for d in DATASET_DIR:
        d.cleanup()
    for name, count in counts.items():
        check(count >= 1, f"{name} was launched {count} times on the main path")
    for form, count in forms.items():
        check(count >= 1, f"K5's {form} form was launched {count} times on the main path")
    cells = {name: timing.pop("ops") for name, timing in timings.items()}
    ops_phase(cells, rank_timing.pop("ops"), smi)
    rank_timing["launches"] = forms["rank"]
    extra = {"cascade_lut": {"stage_of": "K1/K2/K3/K5/K6/K7"},
             "run_expand": {"launches_by_form": forms, "rank_form": rank_timing}}
    rows = [
        {"name": name, "route": "cuda", "source": KERNELS[name][3], "replaces": KERNELS[name][2],
         "launches": counts[name], "max_abs_err": MAX_ABS_ERR[name], **timings[name], **extra.get(name, {})}
        for name in KERNELS
    ]
    print(f"[time] chip_smoke.py: {time.perf_counter() - T_START:.1f} s after its imports; its "
          f"{len(HOST_ENCODE_S)} [encode] host encodes {sum(HOST_ENCODE_S.values()):.2f} s; the [native] phase "
          f"{sum(a + b for a, b in NATIVE_S.values()):.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
