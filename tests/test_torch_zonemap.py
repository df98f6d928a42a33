"""giddy_tpu_torch.zonemap against giddy_tpu.zonemap on the CPU, from the
same numpy-seeded columns: the zone map's per-group bounds (dtype and bits)
and sortedness, candidate_groups, count_where_pruned at every op and
several thresholds (clustered, float, nullable and wide columns, the
undecided groups decoding through the port's GroupSlicer), searchsorted on
both sides, and the refusals. Tolerance 0."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import zonemap as jz
from giddy_tpu_torch import zonemap
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import OPS, rng_of, wide_key, wide_values

N = 2 * GROUP + 999  # three groups, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _values(kind: str, rng) -> np.ndarray:
    if kind == "clustered":  # a sorted ramp plus noise, so that pruning fires
        return np.sort(np.arange(N) // 100 + rng.integers(0, 5, N)).astype(np.int32)
    if kind == "float32":
        return np.sort(rng.normal(0, 100, N)).astype(np.float32)
    if kind == "random":
        return rng.integers(-500, 500, N).astype(np.int16)
    if kind == "wide-float64":  # sorted in total order: -NaN first, NaN last, -0.0 before 0.0
        v = wide_values("float64", N, rng)
        return v[np.argsort(wide_key(v), kind="stable")]
    return wide_values(kind.removeprefix("wide-"), N, rng)


# (values kind, scheme or wide lo-plane scheme, nullable)
CASES = [
    ("clustered", "delta", False), ("float32", "raw", False), ("random", "nbit", False),
    ("clustered", "for", True), ("wide-orderkey", "delta", False), ("wide-float64", "nbit", False),
    ("wide-orderkey", "delta", True),
]
IDS = [f"{k}-{s}{'-nulls' if nul else ''}" for k, s, nul in CASES]
_COLUMNS = {}


def column(case: int):
    if case not in _COLUMNS:
        kind, scheme, nullable = CASES[case]
        rng = rng_of(f"zonemap/{IDS[case]}")
        v = _values(kind, rng)
        valid = rng.random(v.shape[0]) > 0.1 if nullable else None
        if kind.startswith("wide"):
            ref = gt.encode(v, "wide", valid=valid, base_scheme=scheme, hi_scheme="nbit")
        else:
            ref = gt.encode(v, scheme, valid=valid)
        _COLUMNS[case] = v, valid, ref, gtt.from_reference(ref)
    return _COLUMNS[case]


def thresholds(v: np.ndarray) -> list:
    return [v[0].item(), v[len(v) // 2].item(), v[GROUP].item(), v[-1].item(), v.max().item()]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_zone_map_and_pruned_counts_match_jax(case):
    v, valid, ref, col = column(case)
    zm, want = zonemap.zone_map(col), jz.zone_map(ref)
    assert zonemap.zone_map(col) is zm  # cached on the column
    for f in ("mins", "maxs"):
        got, exp = getattr(zm, f), getattr(want, f)
        assert got.dtype == exp.dtype and got.tobytes() == exp.tobytes(), f
    assert (zm.n, zm.dtype, zm.sorted_, zm.ng) == (want.n, want.dtype, want.sorted_, want.ng)
    for op in OPS:
        for value in thresholds(v):
            assert np.array_equal(zonemap.candidate_groups(zm, op, value), jz.candidate_groups(want, op, value))
            got = zonemap.count_where_pruned(col, op, value, device="cpu")
            assert got == jz.count_where_pruned(ref, op, value), (op, value)
            assert got == gtt.query.count_where(col, op, value, device="cpu"), (op, value)


@pytest.mark.parametrize("case", [i for i, c in enumerate(CASES) if c[0] != "random"], ids=[
    IDS[i] for i, c in enumerate(CASES) if c[0] != "random"])
def test_searchsorted_matches_jax(case):
    v, valid, ref, col = column(case)
    if valid is not None:
        v = gt.nulls.fill_nulls(v, valid)
    rng = rng_of(f"zonemap/search/{IDS[case]}")
    q = np.concatenate([v[rng.integers(0, v.shape[0], 20)], v[[0, -1]], np.array(thresholds(v), v.dtype)])
    for side in ("left", "right"):
        got = zonemap.searchsorted(col, q, side=side, device="cpu")
        assert got.dtype == np.int64 and np.array_equal(got, jz.searchsorted(ref, q, side=side))
        assert np.array_equal(got, np.searchsorted(v, q, side=side)) or v.dtype.kind == "f"
    assert zonemap.searchsorted(col, v[7], device="cpu") == jz.searchsorted(ref, v[7])


def test_refusals_match_jax():
    ref = gt.encode(np.array([5, 3, 1], np.int32), "raw")
    with pytest.raises(ValueError, match="sorted"):
        zonemap.searchsorted(gtt.from_reference(ref), 3, device="cpu")
    with pytest.raises(ValueError, match="side"):
        zonemap.searchsorted(gtt.from_reference(ref), 3, side="middle", device="cpu")
    with pytest.raises(ValueError, match="op must be one of"):
        zonemap.count_where_pruned(gtt.from_reference(ref), "lte", 3, device="cpu")
    empty = gt.encode(np.zeros(0, np.int32), "nbit")
    with pytest.raises(ValueError):
        jz.zone_map(empty)
    with pytest.raises(ValueError):
        zonemap.zone_map(gtt.from_reference(empty))
