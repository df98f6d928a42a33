"""giddy_tpu_torch.topk against giddy_tpu.topk on the CPU, from the same
numpy-seeded columns: top_k values and positions in the same order, ties
included (the reference's lax.top_k returns the lower position first; the
port ranks one int64 key that embeds the position), over several schemes
and every 32-bit-or-narrower dtype, floats with NaN and -0.0, nullable
columns, the sentinel collision and its host redo, wide columns (the host
path), argmax_/argmin_ and order_by. Tolerance 0.

Every call of the reference runs in the worker's reference process
(test_torch_inputs.JAX), which keeps each case's reference column: the
worker itself imports no JAX and keeps none of its programs."""

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import topk
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX, rng_of, scan_values, wide_values

N = 2 * GROUP + 999  # three groups, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (label, scheme, dtype or None for datagen's values, nullable)
CASES = [
    ("nbit", "nbit", None, False), ("for", "for", None, False), ("delta", "delta", None, False),
    ("dict", "dict", None, False), ("rle", "rle", None, False), ("patched", "patched", None, False),
    ("cascade", "cascade", None, False), ("uint32", "nbit", "uint32", False), ("float32", "raw", "float32", False),
    ("int8-ties", "nbit", "int8", False), ("int16", "dzbf", "int16", False), ("uint16-ties", "rle", "uint16", False),
    ("int32-nulls", "raw", "int32", True), ("float32-nulls", "nbit", "float32", True),
]
LABELS = [c[0] for c in CASES]
_COLUMNS = {}
_REFERENCE = {}  # in the reference process: case -> the reference's column


def values(case: int):
    """(values, validity or None) of a case, from its seed."""
    label, scheme, dtype, nullable = CASES[case]
    rng = rng_of(f"topk/{label}")
    v = gen_column(scheme, N, rng) if dtype is None else scan_values(dtype, N, rng)
    if label.endswith("-ties"):
        v = v[rng.integers(0, 7, N)]  # seven distinct values: every selection ties
    return v, rng.random(N) > 0.2 if nullable else None


def sentinel_values():
    """INT32_MIN everywhere but one row, row 0 null; and a 10-row column
    with 3 valid rows."""
    v = np.full(GROUP + 3, -(2**31), np.int32)
    v[5] = 7
    m = np.ones(v.shape[0], bool)
    m[0] = False
    return v, m, v[:10], np.arange(10) < 3


def wide_case(kind: str):
    rng = rng_of(f"topk/wide/{kind}")
    v = wide_values(kind, N, rng)
    v[rng.integers(0, N, 500)] = v[7]  # ties
    return v, rng.random(N) > 0.1 if kind == "int64" else None


def selection(result) -> tuple:
    return tuple(np.asarray(x) for x in result)


# What runs in the reference process: the reference's columns and selections,
# each column handed back as the port's copy of it.

def reference_column(case: int):
    if case not in _REFERENCE:
        import giddy_tpu as gt

        v, valid = values(case)
        _REFERENCE[case] = gt.encode(v, CASES[case][1], valid=valid)
    return _REFERENCE[case]


def reference_copy(case: int):
    return gtt.from_reference(reference_column(case))


def reference_top_k(case: int, calls: list) -> list:
    from giddy_tpu import topk as jt

    return [selection(jt.top_k(reference_column(case), k, largest=largest)) for k, largest in calls]


def reference_sentinel():
    import giddy_tpu as gt
    from giddy_tpu import topk as jt

    v, m, small, small_valid = sentinel_values()
    ref = gt.encode(v, "raw", valid=m)
    return (gtt.from_reference(ref), selection(jt.top_k(ref, 3, largest=False)),
            gtt.from_reference(gt.encode(small, "raw", valid=small_valid)))


def reference_wide(kind: str, calls: list):
    import giddy_tpu as gt
    from giddy_tpu import topk as jt

    v, valid = wide_case(kind)
    ref = gt.encode(v, "wide", valid=valid)
    return gtt.from_reference(ref), [selection(jt.top_k(ref, k, largest=largest)) for k, largest in calls]


def reference_orders(case: int, nullable_case: int) -> dict:
    from giddy_tpu import topk as jt

    ref, nref = reference_column(case), reference_column(nullable_case)
    out = {"argmax": int(jt.argmax_(ref)), "argmin": int(jt.argmin_(ref)), "nullable": selection(jt.order_by(nref))}
    for asc in (True, False):
        out[asc] = selection(jt.order_by(ref, ascending=asc))
        out[asc, 5] = selection(jt.order_by(ref, ascending=asc, limit=5))
    return out


def reference_empty():
    import giddy_tpu as gt
    from giddy_tpu import topk as jt

    ref = gt.encode(np.zeros(0, np.int32), "nbit")
    return gtt.from_reference(ref), selection(jt.top_k(ref, 5))


def column(case: int):
    """(values, validity or None, port column: the reference's, copied),
    made once."""
    if case not in _COLUMNS:
        _COLUMNS[case] = (*values(case), JAX(reference_copy, case))
    return _COLUMNS[case]


def same_selection(got, want) -> None:
    (gv, gp), (wv, wp) = got, want
    wv, wp = np.asarray(wv), np.asarray(wp)
    assert gv.dtype == wv.dtype and gp.dtype == wp.dtype == np.int64
    assert gv.tobytes() == wv.tobytes() and np.array_equal(gp, wp)


@pytest.mark.parametrize("case", range(len(CASES)), ids=LABELS)
def test_top_k_matches_jax(case):
    v, valid, col = column(case)
    calls = [(100, True), (100, False), (1, True)]
    for (k, largest), want in zip(calls, JAX(reference_top_k, case, calls)):
        got = topk.top_k(col, k, largest=largest, device="cpu")
        same_selection(got, want)
        pos = got[1]
        assert len(set(pos.tolist())) == len(pos) and got[0].tobytes() == v[pos].tobytes()
        if valid is not None:
            assert valid[pos].all()


def test_ties_come_back_lowest_position_first():
    v, _, col = column(LABELS.index("int8-ties"))
    vals, pos = topk.top_k(col, 2000, largest=False, device="cpu")
    for x in np.unique(vals):
        p = pos[vals == x]
        assert np.array_equal(p, np.sort(p))


def test_sentinel_collision_redoes_on_the_host():
    """INT32_MIN rows hold the mask's key: with a null row there too, the
    selection brushes it and the host redo keeps only valid rows."""
    _, m, _, _ = sentinel_values()
    col, want, small = JAX(reference_sentinel)
    got = topk.top_k(col, 3, largest=False, device="cpu")
    same_selection(got, want)
    assert m[got[1]].all() and (got[1] != 0).all()
    assert len(topk.top_k(small, 8, device="cpu")[0]) == 3


@pytest.mark.parametrize("kind", ["int64", "uint64", "float64"])
def test_top_k_wide_matches_jax(kind):
    # the salted ends repeat: k = 5 cuts inside a run of equal keys
    calls = [(k, largest) for k in (5, 50) for largest in (True, False)]
    col, wants = JAX(reference_wide, kind, calls)
    for (k, largest), want in zip(calls, wants):
        same_selection(topk.top_k(col, k, largest=largest, device="cpu"), want)


def test_argminmax_and_order_by_match_jax():
    case, nullable_case = LABELS.index("float32"), LABELS.index("int32-nulls")
    _, _, col = column(case)
    want = JAX(reference_orders, case, nullable_case)
    assert topk.argmax_(col, device="cpu") == want["argmax"]
    assert topk.argmin_(col, device="cpu") == want["argmin"]
    for asc in (True, False):
        same_selection(topk.order_by(col, ascending=asc, device="cpu"), want[asc])
        same_selection(topk.order_by(col, ascending=asc, limit=5, device="cpu"), want[asc, 5])
    same_selection(topk.order_by(column(nullable_case)[2], device="cpu"), want["nullable"])


def test_bad_k_and_empty_columns():
    col = gtt.encode(np.arange(10, dtype=np.int32), "raw")
    with pytest.raises(ValueError, match="positive"):
        topk.top_k(col, 0, device="cpu")
    col, want = JAX(reference_empty)
    same_selection(topk.top_k(col, 5, device="cpu"), want)
