"""giddy_tpu_torch's 64-bit (wide) columns against giddy_tpu's on the CPU,
from the same numpy-seeded columns: encode byte for byte, decode and
decode_columns bit for bit, the scan layer's wide branches (filter_bitmap
word for word, pad bits included; isin_bitmap; count_where) and the
aggregates (sum_, min_, max_, avg_, distinct_count) exactly. There both
planes decode through the port's plain kernel versions and the reference's
Pallas kernels in interpret mode. Tolerance 0 throughout. The same paths on
the card are held to the CPU by test_torch_cuda.py.

Every call of the reference runs in the worker's reference process
(test_torch_inputs.JAX), which keeps each case's reference column: the
worker itself imports no JAX and keeps none of its interpret-mode
programs."""

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import aggregate, query, wide
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX, OPS, assert_same_column, rng_of, want_wide_mask, wide_thresholds, wide_values

N = 2 * GROUP + 999  # three groups, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The cases run many small torch ops; beside the other test workers,
    torch's thread pool only adds contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (values kind, lo-plane scheme, hi-plane scheme, nullable, n)
CASES = [
    ("int64", "nbit", None, False, N),
    ("orderkey", "delta", "nbit", False, N),
    ("uint64", "raw", "for", False, N),
    ("float64", "nbit", None, False, N),
    ("orderkey", "delta", "nbit", True, N),
    ("float64", "dzbf", None, True, N),
    ("int64", "nbit", None, False, 0),
]
IDS = [f"{k}-{lo}-{hi or lo}{'-nulls' if nul else ''}-n{n}" for k, lo, hi, nul, n in CASES]
_COLUMNS = {}
_REFERENCE = {}  # in the reference process: case -> the reference's column


def values(case: int):
    """(values, validity or None) of a case, from its seed."""
    kind, _, _, nullable, n = CASES[case]
    rng = rng_of(f"wide/{IDS[case]}")
    v = wide_values(kind, n, rng)
    return v, rng.random(n) > 0.1 if nullable else None


def reference_column(case: int):
    """The reference's column of a case (in the reference process), made once."""
    if case not in _REFERENCE:
        import giddy_tpu as gt

        _, lo, hi, _, _ = CASES[case]
        v, valid = values(case)
        _REFERENCE[case] = gt.encode(v, "wide", valid=valid, base_scheme=lo, hi_scheme=hi, name="w")
    return _REFERENCE[case]


def reference_copy(case: int):
    """(the values a nullable column decodes to by the reference's
    canonical fill, the port's copy of the reference's column)."""
    import giddy_tpu as gt

    v, valid = values(case)
    return v if valid is None else gt.nulls.fill_nulls(v, valid), gtt.from_reference(reference_column(case))


def reference_decode(case: int) -> np.ndarray:
    import giddy_tpu as gt

    return np.asarray(gt.decode(reference_column(case)))


def reference_filter_words(case: int, predicates: list) -> list[bytes]:
    from giddy_tpu import query as jq

    return [words(jq.filter_bitmap(reference_column(case), op, value)) for op, value in predicates]


def reference_isin_words(case: int, picks: list) -> tuple[bytes, bytes]:
    from giddy_tpu import query as jq

    ref = reference_column(case)
    return words(jq.isin_bitmap(ref, picks)), words(jq.isin_bitmap(ref, []))


def reference_aggregates(case: int) -> dict:
    """fn -> ("value", its result) or ("error", a ValueError's message)."""
    from giddy_tpu import aggregate as ja

    out = {}
    for fn in ("sum_", "min_", "max_", "avg_", "distinct_count"):
        try:
            out[fn] = ("value", getattr(ja, fn)(reference_column(case)))
        except ValueError as e:
            out[fn] = ("error", str(e))
    return out


def column(case: int):
    """(values, validity or None, the reference's fill of them, port
    column: the reference's, copied), made once."""
    if case not in _COLUMNS:
        v, valid = values(case)
        _COLUMNS[case] = (v, valid, *JAX(reference_copy, case))
    return _COLUMNS[case]


def words(bm) -> bytes:
    return bm.numpy().view(np.uint32).tobytes() if isinstance(bm, torch.Tensor) else np.asarray(bm).tobytes()


def bits(a: np.ndarray) -> bytes:
    return a.view(np.uint8).tobytes()


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_wide_encode_decode_matches_jax(case):
    v, valid, fv, col = column(case)
    kind, lo, hi, _, _ = CASES[case]
    assert_same_column(gtt.encode(v, "wide", valid=valid, base_scheme=lo, hi_scheme=hi, name="w"), col)
    want = JAX(reference_decode, case)
    out = gtt.decode(col, device="cpu")
    assert out.dtype == wide.TORCH_DTYPES[col.dtype] and out.device.type == "cpu"
    got = out.numpy()
    assert got.dtype == want.dtype and bits(got) == bits(want) == bits(fv)
    assert bits(gtt.decode_ref(col)) == bits(want)
    padded = gtt.decode(col, device="cpu", pad=True).numpy()
    assert padded.shape == (gtt.util.num_groups(col.n) * GROUP,) and bits(padded[: col.n]) == bits(want)
    # beside a 32-bit column in one container
    other = gtt.encode(np.arange(col.n, dtype=np.int32), "nbit", name="i")
    outs = gtt.decode_columns([col, other], device="cpu")
    assert bits(outs["w"].numpy()) == bits(want) and np.array_equal(outs["i"].numpy(), np.arange(col.n))


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_wide_filter_bitmap_matches_jax(case):
    """Every op at every threshold against the NumPy oracle; two ops a case
    against JAX word for word (each a fresh interpret-mode trace)."""
    v, valid, fv, col = column(case)
    thresholds = wide_thresholds(fv)
    jax_ops = [op for j, op in enumerate(OPS) if j in (case % 6, (case + 3) % 6)]
    jax_words = iter(JAX(reference_filter_words, case, [(op, value) for op in jax_ops for value in thresholds]))
    for op in OPS:
        for value in thresholds:
            bm = query.filter_bitmap(col, op, value, device="cpu")
            assert bm.dtype == torch.int32 and bm.shape == (gtt.util.num_groups(col.n), gtt.LANES)
            if op in jax_ops:
                assert words(bm) == next(jax_words), (op, value)
            want = want_wide_mask(fv, op, value, valid)
            assert np.array_equal(query.where_mask(col, op, value, device="cpu"), want), (op, value)
            assert query.count_where(col, op, value, device="cpu") == int(want.sum())


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_wide_isin_matches_jax(case):
    v, valid, fv, col = column(case)
    picks = list(fv[:: max(1, len(fv) // 11)][:11]) + wide_thresholds(fv)
    want, want_empty = JAX(reference_isin_words, case, picks)
    bm = query.isin_bitmap(col, picks, device="cpu")
    assert words(bm) == want
    key = fv.view(np.uint64)
    want = np.isin(key, np.array(picks, fv.dtype).view(np.uint64))
    assert np.array_equal(gtt.query.count_bits(bm, col.n), int((want & (True if valid is None else valid)).sum()))
    assert words(query.isin_bitmap(col, [], device="cpu")) == want_empty


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_wide_aggregates_match_jax(case):
    """sum_, min_, max_, avg_ and distinct_count equal the reference's
    exactly (floats by their bits, so NaN and -0.0 count), errors too."""
    v, valid, _, col = column(case)
    for fn, (kind, want) in JAX(reference_aggregates, case).items():
        if kind == "error":
            with pytest.raises(ValueError, match=want.split(" ")[0]):
                getattr(aggregate, fn)(col, device="cpu")
            continue
        got = getattr(aggregate, fn)(col, device="cpu")
        assert type(got) is type(want), fn
        if isinstance(want, float):
            assert np.float64(got).view(np.uint64) == np.float64(want).view(np.uint64), fn
        else:
            assert got == want, fn
    if col.n and v.dtype.kind != "f":
        assert aggregate.sum_(col, device="cpu") == int(v[valid if valid is not None else slice(None)].astype(object).sum())


def test_wide_column_compare_stays_refused():
    _, _, _, col = column(0)
    with pytest.raises(NotImplementedError, match="64-bit"):
        query.filter_bitmap_cols(col, col, "lt", device="cpu")


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float64"])
def test_combine_views_each_dtype(dtype):
    """The int64 recombine, viewed as the logical dtype at the end, agrees
    with the host combine bit for bit at both planes' extremes."""
    lo = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 7], np.uint32)
    hi = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xFFF00000], np.uint32)
    t = wide.combine_device(torch.from_numpy(lo.view(np.int32)), torch.from_numpy(hi.view(np.int32)), dtype)
    assert t.dtype == wide.TORCH_DTYPES[dtype]
    assert bits(t.numpy()) == bits(wide._combine(lo, hi, dtype))
