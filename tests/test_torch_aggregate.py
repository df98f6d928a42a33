"""giddy_tpu_torch.aggregate against giddy_tpu.aggregate on the CPU, from
the same numpy-seeded columns. There the port's fused aggregate runs the
plain version of K17 (kernels/lanes.agg_fold) and the reference its Pallas
kernel (``_epilogue_agg_call``) in interpret mode: their (ng, LANES)
partials are compared bit for bit. ``sum_``, ``min_``, ``max_``, ``avg_``
and ``distinct_count`` must equal the reference's exactly (floats with
``==``, NaN by its bits) and the NumPy oracle of test_torch_inputs. The CUDA
kernel is held against the same plain version on the card by
test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import aggregate as ja
from giddy_tpu_torch import aggregate, kernels, nulls
from giddy_tpu_torch.kernels import agg
from giddy_tpu_torch.util import GROUP, np_dtype

from test_torch_inputs import rng_of, scan_values, want_agg

N = 2 * GROUP + 999  # three groups, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The cases run many small torch ops; beside the other test workers,
    torch's thread pool only adds contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
FUSED = ["nbit", "dzbf", "for"]
ENTRY_POINTS = ["sum_", "min_", "max_", "avg_", "distinct_count"]


def column(scheme: str, dtype: str, n: int = N, nullable: bool = False, **opts):
    """(values, validity or None, reference column, port column)."""
    rng = rng_of(f"agg/{scheme}/{dtype}/{n}/{nullable}")
    v = scan_values(dtype, n, rng)
    if scheme in ("rle", "cascade"):
        v = np.repeat(v[: n // 50 + 1], 50)[:n]
    elif scheme == "dict":
        v = v[rng.integers(0, 40, n)]
    valid = rng.random(n) > 0.1 if nullable else None
    ref = gt.encode(v, scheme, valid=valid, **opts)
    return v, valid, ref, gtt.from_reference(ref)


def same(a, b) -> bool:
    """Equal values of equal type; floats by their float32 bits (NaN)."""
    if isinstance(a, float) or isinstance(b, float):
        return type(a) is type(b) and (a == b or np.float32(a).view(np.uint32) == np.float32(b).view(np.uint32))
    return type(a) is type(b) and a == b


def port_value(col, fn: str):
    return getattr(aggregate, fn)(col, device="cpu")


# K17's plain version against the Pallas kernel: every fused scheme, the
# dtypes that change its arithmetic (sign counts, narrow sign extension,
# float keys) and nullable sums; each agg is a fresh interpret-mode trace,
# which the reference's entry points then reuse
PARTIAL_CASES = [("nbit", "int32", False), ("nbit", "int8", False), ("dzbf", "uint16", True),
                 ("dzbf", "float32", False), ("for", "uint32", True), ("for", "int16", False), ("nbit", "uint8", True)]


@pytest.mark.parametrize("scheme,dtype,nullable", PARTIAL_CASES)
def test_agg_fold_partials_and_entry_points_match_jax(scheme, dtype, nullable):
    v, valid, ref, col = column(scheme, dtype, nullable=nullable)
    dt = np_dtype(col.dtype)
    streams = gtt.device_streams(col, "cpu")
    bits = col.params["bits"] if scheme != "dzbf" else 8 * col.params["width"]
    before = kernels.launches()
    for name in ("sum", "min", "max"):
        vw = nulls.valid_words_device(col, "cpu") if nullable and name == "sum" else None
        got = agg.agg_fold(streams["packed"], streams.get("refs_g"), vw, bits, col.n, dt.kind, dt.itemsize, name)
        want = ja._run(ref, name)
        assert len(got) == len(want) == (3 if name == "sum" else 1)
        for g, w in zip(got, want):
            assert g.shape == (3, 1024) and g.numpy().tobytes() == np.asarray(w).tobytes()
    assert kernels.launches() == before  # the CPU path launches no kernel
    for fn in ENTRY_POINTS:
        got, want = port_value(col, fn), getattr(ja, fn)(ref)
        assert same(got, want), (fn, got, want)
    for fn in ("sum", "min", "max"):
        assert same(port_value(col, f"{fn}_"), want_agg(v, fn, valid)), fn


# every entry point of the general path against JAX: each other scheme, at
# a dtype that changes its path (float sums decode; narrow sign handling),
# nullable where the scheme's null handling differs
ENTRY_CASES = [("delta", "int16", False), ("dict", "int32", True), ("dict", "float32", False),
               ("rle", "float32", False), ("cascade", "uint16", True)]


@pytest.mark.parametrize("scheme,dtype,nullable", ENTRY_CASES)
def test_entry_points_match_jax(scheme, dtype, nullable):
    v, valid, ref, col = column(scheme, dtype, nullable=nullable)
    for fn in ENTRY_POINTS:
        got, want = port_value(col, fn), getattr(ja, fn)(ref)
        assert same(got, want), (fn, got, want)
    for fn in ("sum", "min", "max"):
        assert same(port_value(col, f"{fn}_"), want_agg(v, fn, valid)), fn


@pytest.mark.parametrize("scheme", ["nbit", "delta", "dict"])
def test_float_sums_keep_numpys_order(scheme):
    """Finite float32 values whose float64 sum depends on the order of the
    adds: the port decodes and sums on the host as the reference does."""
    rng = rng_of(f"fsum/{scheme}")
    v = (rng.normal(0, 1, N) * 10.0 ** rng.integers(-6, 9, N)).astype(np.float32)
    if scheme == "dict":
        v = v[rng.integers(0, 40, N)]
    ref = gt.encode(v, scheme)
    got = port_value(gtt.from_reference(ref), "sum_")
    assert type(got) is float and got == ja.sum_(ref) == float(np.sum(v, dtype=np.float64))


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32", "int8", "int16", "uint8", "uint16"])
@pytest.mark.parametrize("scheme", FUSED + ["delta", "dict", "rle", "cascade"])
def test_entry_points_match_oracle(scheme, dtype):
    """Every scheme and dtype against the NumPy oracle alone, at 5 groups
    and a ragged tail; the sums overflow 32 bits in every lane."""
    v, valid, _, col = column(scheme, dtype, n=4 * GROUP + 321, nullable=scheme in ("for", "dict"))
    for fn in ("sum", "min", "max"):
        assert same(port_value(col, f"{fn}_"), want_agg(v, fn, valid)), fn
    nv = len(v) if valid is None else int(valid.sum())
    assert same(port_value(col, "avg_"), float(want_agg(v, "sum", valid)) / nv)
    live = v if valid is None else v[valid]
    assert port_value(col, "distinct_count") == np.unique(live.view(np.uint32) if dtype == "float32" else live).size


@pytest.mark.parametrize("scheme", ["dict", "cascade"])
def test_dictionary_shortcuts_match_jax(scheme):
    """An auto-built (dense) dictionary answers min/max/distinct from its
    header; an explicit one with unused entries goes through the codes."""
    rng = rng_of(f"dense/{scheme}")
    vocab = np.arange(-50, 50, dtype=np.int32) * 1_000_003
    v = vocab[rng.integers(10, 60, N)]
    for opts in ({}, {"dictionary": vocab}):
        ref = gt.encode(v, scheme, **opts)
        col = gtt.from_reference(ref)
        assert col.params["dense"] == (not opts)
        for fn in ("min_", "max_", "distinct_count"):  # the dictionary sum is test_entry_points_match_jax's
            assert same(port_value(col, fn), getattr(ja, fn)(ref)), fn
        assert port_value(col, "distinct_count") == np.unique(v).size


def test_empty_and_all_null_columns():
    for scheme in ("nbit", "dict"):
        for v, valid in ((np.zeros(0, np.int32), None), (np.arange(100, dtype=np.int32), np.zeros(100, bool))):
            ref = gt.encode(v, scheme, valid=valid)
            col = gtt.from_reference(ref)
            for fn in ("min_", "max_", "avg_"):
                with pytest.raises(ValueError):
                    port_value(col, fn)
                with pytest.raises(ValueError):
                    getattr(ja, fn)(ref)
            assert port_value(col, "sum_") == ja.sum_(ref) == 0
            assert port_value(col, "distinct_count") == ja.distinct_count(ref) == 0


def test_key_unmap_matches_jax():
    keys = [-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1, 0x7F800000, -0x7F800001, 12345]
    for dtype in ("int32", "uint32", "float32", "int8", "uint16"):
        for k in keys:
            assert same(aggregate._key_unmap_host(k, dtype), ja._key_unmap_host(k, dtype))


def test_aggregates_refuse_what_is_not_ported():
    """Wide columns now aggregate, equal to the reference; what stays
    refused: a 64-bit dtype on a scheme other than wide, and a device that
    is neither the card nor the CPU."""
    ref = gt.encode(np.arange(10, dtype=np.int64) * -(2**40), "wide")
    wide = gtt.from_reference(ref)
    for fn in ("sum_", "min_", "max_", "avg_", "distinct_count"):
        assert same(port_value(wide, fn), getattr(ja, fn)(ref)), fn
    assert port_value(wide, "sum_") == -45 * 2**40
    col = gtt.encode(np.arange(10, dtype=np.int32), "nbit")
    col.dtype = "int64"
    with pytest.raises(NotImplementedError, match="'wide' scheme"):
        port_value(col, "sum_")
    with pytest.raises(ValueError, match="no decoder for device"):
        aggregate.sum_(gtt.encode(np.arange(10, dtype=np.int32), "nbit"), device="meta")
