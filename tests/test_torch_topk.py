"""giddy_tpu_torch.topk against giddy_tpu.topk on the CPU, from the same
numpy-seeded columns: top_k values and positions in the same order, ties
included (the reference's lax.top_k returns the lower position first; the
port ranks one int64 key that embeds the position), over several schemes
and every 32-bit-or-narrower dtype, floats with NaN and -0.0, nullable
columns, the sentinel collision and its host redo, wide columns (the host
path), argmax_/argmin_ and order_by. Tolerance 0."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import topk as jt
from giddy_tpu_torch import topk
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import rng_of, scan_values, wide_values

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
_COLUMNS = {}


def column(case: int):
    if case not in _COLUMNS:
        label, scheme, dtype, nullable = CASES[case]
        rng = rng_of(f"topk/{label}")
        v = gen_column(scheme, N, rng) if dtype is None else scan_values(dtype, N, rng)
        if label.endswith("-ties"):
            v = v[rng.integers(0, 7, N)]  # seven distinct values: every selection ties
        valid = rng.random(N) > 0.2 if nullable else None
        ref = gt.encode(v, scheme, valid=valid)
        _COLUMNS[case] = v, valid, ref, gtt.from_reference(ref)
    return _COLUMNS[case]


def same_selection(got, want) -> None:
    (gv, gp), (wv, wp) = got, want
    wv, wp = np.asarray(wv), np.asarray(wp)
    assert gv.dtype == wv.dtype and gp.dtype == wp.dtype == np.int64
    assert gv.tobytes() == wv.tobytes() and np.array_equal(gp, wp)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_top_k_matches_jax(case):
    v, valid, ref, col = column(case)
    for k, largest in ((100, True), (100, False), (1, True)):
        got = topk.top_k(col, k, largest=largest, device="cpu")
        same_selection(got, jt.top_k(ref, k, largest=largest))
        pos = got[1]
        assert len(set(pos.tolist())) == len(pos) and got[0].tobytes() == v[pos].tobytes()
        if valid is not None:
            assert valid[pos].all()


def test_ties_come_back_lowest_position_first():
    v, _, _, col = column([c[0] for c in CASES].index("int8-ties"))
    vals, pos = topk.top_k(col, 2000, largest=False, device="cpu")
    for x in np.unique(vals):
        p = pos[vals == x]
        assert np.array_equal(p, np.sort(p))


def test_sentinel_collision_redoes_on_the_host():
    """INT32_MIN rows hold the mask's key: with a null row there too, the
    selection brushes it and the host redo keeps only valid rows."""
    v = np.full(GROUP + 3, -(2**31), np.int32)
    v[5] = 7
    m = np.ones(v.shape[0], bool)
    m[0] = False
    ref = gt.encode(v, "raw", valid=m)
    col = gtt.from_reference(ref)
    got = topk.top_k(col, 3, largest=False, device="cpu")
    same_selection(got, jt.top_k(ref, 3, largest=False))
    assert m[got[1]].all() and (got[1] != 0).all()
    small = gtt.from_reference(gt.encode(v[:10], "raw", valid=np.arange(10) < 3))
    assert len(topk.top_k(small, 8, device="cpu")[0]) == 3


@pytest.mark.parametrize("kind", ["int64", "uint64", "float64"])
def test_top_k_wide_matches_jax(kind):
    rng = rng_of(f"topk/wide/{kind}")
    v = wide_values(kind, N, rng)
    v[rng.integers(0, N, 500)] = v[7]  # ties
    valid = rng.random(N) > 0.1 if kind == "int64" else None
    ref = gt.encode(v, "wide", valid=valid)
    col = gtt.from_reference(ref)
    for k in (5, 50):  # the salted ends repeat: k = 5 cuts inside a run of equal keys
        for largest in (True, False):
            same_selection(topk.top_k(col, k, largest=largest, device="cpu"), jt.top_k(ref, k, largest=largest))


def test_argminmax_and_order_by_match_jax():
    v, _, ref, col = column([c[0] for c in CASES].index("float32"))
    assert topk.argmax_(col, device="cpu") == jt.argmax_(ref)
    assert topk.argmin_(col, device="cpu") == jt.argmin_(ref)
    for asc in (True, False):
        same_selection(topk.order_by(col, ascending=asc, device="cpu"), jt.order_by(ref, ascending=asc))
        same_selection(topk.order_by(col, ascending=asc, limit=5, device="cpu"), jt.order_by(ref, ascending=asc, limit=5))
    _, _, nref, ncol = column([c[0] for c in CASES].index("int32-nulls"))
    same_selection(topk.order_by(ncol, device="cpu"), jt.order_by(nref))


def test_bad_k_and_empty_columns():
    col = gtt.encode(np.arange(10, dtype=np.int32), "raw")
    with pytest.raises(ValueError, match="positive"):
        topk.top_k(col, 0, device="cpu")
    ref = gt.encode(np.zeros(0, np.int32), "nbit")
    same_selection(topk.top_k(gtt.from_reference(ref), 5, device="cpu"), jt.top_k(ref, 5))
