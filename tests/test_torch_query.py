"""giddy_tpu_torch.query against giddy_tpu.query on the CPU, from the same
numpy-seeded columns. There the port's fused filter runs the plain version
of K16 (kernels/lanes.filter_fold) and the reference its Pallas kernel in
interpret mode; the other schemes decode and compare on both sides.
Bitmap words are compared bit for bit, pad bits included (tolerance 0);
counts exactly, and against the NumPy oracle of test_torch_inputs. The
CUDA kernel itself is held against the same plain version on the card by
test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import query as jq
from giddy_tpu_torch import kernels, query
from giddy_tpu_torch.kernels import _wrap, agg, filter_
from giddy_tpu_torch.util import GROUP, LANES, dtype_to_u32

from test_torch_inputs import OPS, SCAN_DTYPES, rng_of, scan_key, scan_thresholds, scan_values, want_mask

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


def column(scheme: str, dtype: str, n: int = N, nullable: bool = False, **opts):
    """(values, validity or None, reference column, port column)."""
    rng = rng_of(f"{scheme}/{dtype}/{n}/{nullable}")
    v = scan_values(dtype, n, rng)
    if scheme in ("rle", "cascade"):
        v = np.repeat(v[: n // 50 + 1], 50)[:n]
    elif scheme == "dict":
        v = v[rng.integers(0, 40, n)]
    valid = rng.random(n) > 0.1 if nullable else None
    ref = gt.encode(v, scheme, valid=valid, **opts)
    return v, valid, ref, gtt.from_reference(ref)


def words(bm) -> np.ndarray:
    return bm.numpy().view(np.uint32) if isinstance(bm, torch.Tensor) else np.asarray(bm)


def assert_same_bitmap(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert words(got).tobytes() == words(want).tobytes()


# every dtype through K16's plain version; the general path's one compare
# (after each scheme's decoder) at three of them
FILTER_CASES = [(s, t) for s in FUSED for t in SCAN_DTYPES] + [
    (s, t) for s in ("delta", "dict", "rle", "cascade") for t in ("int32", "int16", "float32")]


@pytest.mark.parametrize("case", range(len(FILTER_CASES)), ids=[f"{s}-{t}" for s, t in FILTER_CASES])
def test_filter_bitmap_matches_jax(case):
    """Every op at every threshold against the NumPy oracle; one op a case
    (each op a fresh interpret-mode trace), taken in turn so that every
    scheme and every dtype meets several of the six, against JAX bit for
    bit."""
    scheme, dtype = FILTER_CASES[case]
    v, _, ref, col = column(scheme, dtype)
    before = kernels.launches()
    for op in OPS:
        jax_too = op == OPS[case % 6]
        for value in scan_thresholds(dtype, v):
            bm = query.filter_bitmap(col, op, value, device="cpu")
            if jax_too:
                assert_same_bitmap(bm, jq.filter_bitmap(ref, op, value))
            mask = want_mask(v, op, value)
            assert np.array_equal(query.where_mask(col, op, value, device="cpu"), mask)
            assert query.count_where(col, op, value, device="cpu") == int(mask.sum())
    assert query.count_where(col, OPS[case % 6], value, device="cpu") == jq.count_where(ref, OPS[case % 6], value)
    assert kernels.launches() == before  # the CPU path launches no kernel


@pytest.mark.parametrize("scheme", FUSED + ["delta", "dict", "cascade"])
def test_nullable_filter_matches_jax(scheme):
    dtype = "int16" if scheme != "for" else "uint32"
    v, valid, ref, col = column(scheme, dtype, nullable=True)
    value = int(v[7])
    assert_same_bitmap(query.filter_bitmap(col, "lt", value, device="cpu"), jq.filter_bitmap(ref, "lt", value))
    for op in OPS:
        assert query.count_where(col, op, value, device="cpu") == int(want_mask(v, op, value, valid).sum())


@pytest.mark.parametrize("scheme", ["dict", "cascade"])
@pytest.mark.parametrize("dictionary", ["sorted", "shuffled"])
def test_dict_domain_pushdown_and_fallback(scheme, dictionary):
    """A sorted dictionary turns each predicate into at most two code
    ranges; a shuffled one fragments 'lt 0' past four ranges, and the
    scan falls back to decode + compare."""
    rng = rng_of(f"pushdown/{scheme}/{dictionary}")
    vocab = np.arange(-60, 60, 3, dtype=np.int32)
    if dictionary == "shuffled":
        vocab = rng.permutation(vocab)
    v = vocab[rng.integers(0, vocab.shape[0], N)]
    ref = gt.encode(v, scheme, dictionary=vocab)
    col = gtt.from_reference(ref)
    for op, value in (("lt", 0), ("eq", 3), ("eq", 4), ("ge", 57), ("ne", -60)):
        ranges = query._dict_code_ranges(col, op, value)
        assert (ranges is None) == (dictionary == "shuffled" and op == "lt")
        if op == "lt" or value == 3:  # the fallback, and range scans of eq, lt, ge and between
            assert_same_bitmap(query.filter_bitmap(col, op, value, device="cpu"), jq.filter_bitmap(ref, op, value))
        assert query.count_where(col, op, value, device="cpu") == int(want_mask(v, op, value).sum())


def test_bitmap_algebra_matches_jax():
    v, _, ref, col = column("for", "int32")
    lo, hi = sorted(int(x) for x in v[:2])
    a, b = query.filter_bitmap(col, "ge", lo, device="cpu"), query.filter_bitmap(col, "lt", hi, device="cpu")
    ja, jb = jq.filter_bitmap(ref, "ge", lo), jq.filter_bitmap(ref, "lt", hi)
    assert_same_bitmap(query.bitmap_and(a, b), jq.bitmap_and(ja, jb))
    assert_same_bitmap(query.bitmap_or(a, b), jq.bitmap_or(ja, jb))
    assert_same_bitmap(query.bitmap_not(a, col.n), jq.bitmap_not(ja, ref.n))
    assert_same_bitmap(query.between_bitmap(col, lo, hi, device="cpu"), jq.between_bitmap(ref, lo, hi))
    assert query.count_between(col, lo, hi, device="cpu") == jq.count_between(ref, lo, hi)
    assert query.count_bits(query.bitmap_not(a, col.n), col.n) == int((v < lo).sum())
    assert np.array_equal(query.where_mask(col, "lt", hi, device="cpu"), jq.where_mask(ref, "lt", hi))
    assert query.count_bits(query._mask_pad(torch.full((3, LANES), -1, dtype=torch.int32), N), N) == N
    assert words(torch.from_numpy(query._tail_mask(N).view(np.int32))).tobytes() == jq._tail_mask(N).tobytes()


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int8", "float32"])
def test_isin_matches_jax(dtype):
    """Up to 8 values OR eq scans; more search the staged set. Narrow
    dtypes drop values they cannot hold in both paths alike."""
    v, _, ref, col = column("nbit", dtype)
    picks = [x.item() for x in v[:12]]
    sets = [picks[:3], picks + [picks[0]], [], [2**40, -(2**40)] if dtype != "float32" else [np.nan, -0.0]]
    if dtype == "int8":
        sets.append([300, -5 + 2**32] + picks[:9])  # unrepresentable values drop on both paths
    if dtype == "uint32":
        sets.append([2**32 - 1, 2**31, 2**31 + 7] + picks[:8])  # payloads >= 2^31 in the searched table
    for values in sets:
        assert_same_bitmap(query.isin_bitmap(col, values, device="cpu"), jq.isin_bitmap(ref, values))


def test_isin_nullable_and_dict_mask_match_jax():
    v, _, ref, col = column("delta", "int32", nullable=True)
    values = [int(x) for x in v[:10]]
    assert_same_bitmap(query.isin_bitmap(col, values, device="cpu"), jq.isin_bitmap(ref, values))
    for scheme in ("dict", "cascade"):
        v, _, ref, col = column(scheme, "int32", nullable=True)
        d = col.params["dict_size"]
        rng = rng_of(f"mask/{scheme}")
        for mask in (np.arange(d) % 7 < 3, rng.random(d) < 0.5, np.zeros(d, bool)):  # <= 8 ranges, fragmented, none
            assert_same_bitmap(query.dict_mask_bitmap(col, mask, device="cpu"), jq.dict_mask_bitmap(ref, mask))
        with pytest.raises(ValueError, match="shape"):
            query.dict_mask_bitmap(col, np.ones(d + 1, bool), device="cpu")


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_filter_bitmap_cols_matches_jax(dtype):
    va, valid, ra, a = column("dzbf", dtype, nullable=True)
    vb = scan_values(dtype, N, rng_of(f"cols/{dtype}"))
    vb[::5] = va[::5]
    rb = gt.encode(vb, "delta")
    b = gtt.from_reference(rb)
    ka, kb = scan_key(va), scan_key(vb)
    for op in OPS:
        bm = query.filter_bitmap_cols(a, b, op, device="cpu")
        if op in ("lt", "eq"):
            assert_same_bitmap(bm, jq.filter_bitmap_cols(ra, rb, op))
        want = getattr(np, {"eq": "equal", "ne": "not_equal", "lt": "less", "le": "less_equal", "gt": "greater",
                            "ge": "greater_equal"}[op])(ka, kb) & valid
        assert query.count_where_cols(a, b, op, device="cpu") == int(want.sum())
    with pytest.raises(ValueError, match="length mismatch"):
        query.filter_bitmap_cols(a, gtt.encode(vb[:-1], "delta"), "eq", device="cpu")
    with pytest.raises(ValueError, match="dtype mismatch"):
        query.filter_bitmap_cols(a, gtt.encode(vb.view(np.uint16) if dtype == "int16" else vb.view(np.int32), "nbit"),
                                 "eq", device="cpu")


@pytest.mark.parametrize("scheme", FUSED + ["delta", "rle", "dict"])
def test_scan_matches_oracle_at_larger_n(scheme):
    """Past JAX's cheap sizes: 9 groups and a ragged tail, against the NumPy
    oracle only."""
    v, valid, _, col = column(scheme, "int32", n=9 * GROUP + 123, nullable=scheme in ("for", "dict"))
    for op in OPS:
        value = int(v[100])
        assert query.count_where(col, op, value, device="cpu") == int(want_mask(v, op, value, valid).sum())
        mask = query.where_mask(col, op, value, device="cpu")
        assert np.array_equal(mask, want_mask(v, op, value, valid))


@pytest.mark.parametrize("scheme", FUSED + ["delta", "dict"])
def test_empty_column(scheme):
    ref = gt.encode(np.zeros(0, np.int32), scheme)
    col = gtt.from_reference(ref)
    before = kernels.launches()
    assert query.count_where(col, "ge", 0, device="cpu") == 0 == jq.count_where(ref, "ge", 0)
    assert kernels.launches() == before
    assert_same_bitmap(query.filter_bitmap(col, "ge", 0, device="cpu"), jq.filter_bitmap(ref, "ge", 0))


def test_host_cmp_mask_and_staging_match_jax():
    rng = rng_of("host_cmp")
    for dtype in SCAN_DTYPES:
        v = scan_values(dtype, 4096, rng)
        u = dtype_to_u32(v)
        for op in OPS:
            for value in scan_thresholds(dtype, v):
                assert np.array_equal(query.host_cmp_mask(u, op, value, dtype), jq.host_cmp_mask(u, op, value, dtype))
                assert query._stage_value(dtype, value).tobytes() == jq._stage_value(dtype, value).tobytes()
    assert np.array_equal(query._host_key_u32(u), jq._host_key_u32(u))
    keys = kernels.lanes.order_key(torch.from_numpy(u.view(np.int32)), "f", 4)  # total order, re-biased to signed
    assert np.array_equal(keys.numpy().view(np.uint32) ^ np.uint32(0x80000000), jq._host_key_u32(u))


def _packed(ng=2, bits=9):
    return torch.zeros((ng, bits * LANES), dtype=torch.int32)


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: filter_.filter_fold(_packed(), None, None, 9, "x", 4, "eq", 0), ValueError),
        (lambda: filter_.filter_fold(_packed(), None, None, 9, "i", 3, "eq", 0), ValueError),
        (lambda: filter_.filter_fold(_packed(), None, None, 9, "i", 4, "lte", 0), ValueError),
        (lambda: filter_.filter_fold(_packed(), None, None, 9, "i", 4, "eq", 2**31), ValueError),
        (lambda: filter_.filter_fold(_packed(), torch.zeros(3, dtype=torch.int32), None, 9, "u", 4, "eq", 0), ValueError),
        (lambda: filter_.filter_fold(_packed(), None, torch.zeros((3, LANES), dtype=torch.int32), 9, "u", 4, "eq", 0),
         ValueError),
        (lambda: filter_.filter_fold(_packed(), None, torch.zeros((2, LANES), dtype=torch.int64), 9, "u", 4, "eq", 0),
         TypeError),
        (lambda: agg.agg_fold(_packed(), None, None, 9, 10, "i", 4, "avg"), ValueError),
        (lambda: agg.agg_fold(_packed(), None, None, 9, 2 * GROUP + 1, "i", 4, "sum"), ValueError),
        (lambda: agg.agg_fold(_packed(), None, torch.zeros((2, LANES), dtype=torch.int32), 9, 10, "i", 4, "min"),
         ValueError),
        (lambda: agg.agg_fold(_packed(), torch.zeros(2, dtype=torch.int64), None, 9, 10, "f", 4, "max"), TypeError),
        (lambda: agg.agg_fold(_packed().to("meta"), None, None, 9, 10, "i", 4, "sum"), ValueError),
    ],
)
def test_scan_wrappers_reject_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()


# (stages, blocks an SM) that K16/K17's tile ring takes on an H100, pinned
PLAN_PINS = {1: (8, 4), 9: (6, 4), 16: (3, 4), 32: (2, 3)}


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("bits", range(1, 33))
def test_scan_plan_fits_and_keeps_bytes_in_flight(bits, nullable):
    """K16/K17's tile ring on an H100 (228 KB of shared memory an SM, 1 KB
    of it kept for each block): a block's ring within the 227 KB opt-in,
    the SM's blocks within its shared memory, and >= 16 KB of packed words
    in flight an SM at every width."""
    stages, blocks = _wrap.scan_plan(bits, nullable)
    ring = _wrap.RING_HEADER + stages * (bits + nullable) * 1024  # csrc/scan_epilogue.cu launch_walk
    assert 2 <= stages <= _wrap.MAX_STAGES and 1 <= blocks <= 4
    assert ring <= 227 * 1024 and blocks * (ring + 1024) <= 228 * 1024
    assert blocks * (stages - 1) * bits * 1024 >= 16 * 1024
    if bits in PLAN_PINS and not nullable:
        assert (stages, blocks) == PLAN_PINS[bits]


def test_scan_entry_points_refuse_what_is_not_ported():
    """select/select_where and wide columns now scan; what stays refused:
    an unknown op, n_pad >= 2^31 (the single-call limit), the column-vs-column
    compare of wide columns and the card where there is none."""
    col = gtt.encode(np.arange(10, dtype=np.int32), "nbit")
    ref = gt.encode(np.arange(10, dtype=np.int32), "nbit")
    with pytest.raises(ValueError, match="op must be one of"):
        query.filter_bitmap(col, "lte", 3, device="cpu")
    with pytest.raises(ValueError, match="op must be one of"):
        query.count_where(gtt.encode(np.zeros(0, np.int32), "nbit"), "lte", 3, device="cpu")
    got = query.select_where(col, "lt", 3, device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, jq.select_where(ref, "lt", 3))
    bm = query.filter_bitmap(col, "ge", 7, device="cpu")
    assert np.array_equal(query.select(col, bm, device="cpu"), jq.select(ref, jq.filter_bitmap(ref, "ge", 7)))
    wref = gt.encode(np.arange(10, dtype=np.int64) - 5, "wide")
    wide = gtt.from_reference(wref)
    assert query.count_where(wide, "lt", 3, device="cpu") == jq.count_where(wref, "lt", 3) == 8
    assert np.array_equal(query.select_where(wide, "ge", 3, device="cpu"), jq.select_where(wref, "ge", 3))
    with pytest.raises(NotImplementedError, match="64-bit"):
        query.count_where_cols(wide, wide, "lt", device="cpu")
    col.n = 2**31
    with pytest.raises(NotImplementedError, match="addressing limit"):
        query.filter_bitmap(col, "lt", 3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            query.count_where(gtt.encode(np.arange(10, dtype=np.int32), "nbit"), "lt", 3, device="cuda")
