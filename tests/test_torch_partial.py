"""giddy_tpu_torch.partial and .dist against giddy_tpu's on the CPU, from
the same numpy-seeded columns of every scheme: ``dist_form`` stream for
stream (1 and 2 shards), ``slice_groups`` byte for byte, ``decode_groups``
and ``take`` bit for bit against the JAX package (its Pallas kernels in
interpret mode) and the NumPy oracle, including GroupSlicer's own dzbv and
patched paths, nullable columns and wide columns. Tolerance 0."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import dist as jdist
from giddy_tpu import partial as jpartial
from giddy_tpu_torch import dist, partial
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX, dzbv_values, rng_of, wide_values

N = 2 * GROUP + 999  # three groups, the last one ragged


# The JAX calls run in the worker's reference process (test_torch_inputs.JAX),
# so that the xdist worker keeps none of their interpret-mode programs.


def jax_decode_groups(ref, g0: int, g1: int) -> np.ndarray:
    return np.asarray(jpartial.decode_groups(ref, g0, g1))


def jax_take(ref, idx) -> np.ndarray:
    return np.asarray(jpartial.take(ref, idx))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (label, scheme, encode options); the label picks the values
CASES = [
    ("nbit", "nbit", {}), ("dzbf", "dzbf", {}), ("for", "for", {}), ("delta", "delta", {}),
    ("delta2", "delta2", {}), ("xordelta", "xordelta", {}), ("dict", "dict", {}), ("rle", "rle", {}),
    ("rle-dense", "rle", {}), ("rpe", "rpe", {}), ("model", "model", {}), ("bitmap", "bitmap", {}),
    ("raw", "raw", {}), ("alp", "alp", {}), ("cascade", "cascade", {}),
    ("patched-naive", "patched", {}), ("patched-compressed", "patched", {"kind": "compressed"}),
    ("dzbv-mixed", "dzbv", {}), ("dzbv-skewed", "dzbv", {}), ("dzbv-group_skewed", "dzbv", {}),
    ("delta-nulls", "delta", {}), ("nbit-int16", "nbit", {}), ("nbit-n0", "nbit", {}),
]
IDS = [c[0] for c in CASES]
_COLUMNS = {}


def column(case: int):
    """(values, reference column, port column), made once."""
    if case not in _COLUMNS:
        label, scheme, opts = CASES[case]
        rng = rng_of(f"partial/{label}")
        n = 0 if label.endswith("-n0") else N
        valid = None
        if label.startswith("dzbv"):
            v = dzbv_values(label.split("-")[1], n, rng).view(np.int32)
        elif label == "rle-dense":  # runs of 1-3: the scatter form
            v = np.repeat(rng.integers(-(2**31), 2**31, n, dtype=np.int64), rng.integers(1, 4, n))[:n].astype(np.int32)
        elif label == "nbit-int16":
            v = rng.integers(-(2**15), 2**15, n).astype(np.int16)
        else:
            v = gen_column(scheme, n, rng)
        if label.endswith("-nulls"):
            valid = rng.random(n) > 0.1
        ref = gt.encode(v, scheme, valid=valid, **opts)
        _COLUMNS[case] = (v if valid is None else gt.nulls.fill_nulls(v, valid)), ref, gtt.from_reference(ref)
    return _COLUMNS[case]


def bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def same_streams(port: dict, ref: dict) -> None:
    assert sorted(port) == sorted(ref)
    for k, s in ref.items():
        p = port[k]
        assert (p.dtype, p.shape) == (s.dtype, s.shape) and bits(p) == bits(s), k


def same_column(port, ref) -> None:
    assert (port.name, port.scheme, port.dtype, port.n, port.params) == (ref.name, ref.scheme, ref.dtype, ref.n, ref.params)
    same_streams(port.streams, ref.streams)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dist_form_matches_jax(case):
    """Every field of the form, every stream byte for byte, at 1 and 2 shards."""
    _, ref, col = column(case)
    for shards in (1, 2):
        want, got = jdist.dist_form(ref, shards), dist.dist_form(col, shards)
        same_column(got.local_col, want.local_col)
        same_streams(got.sharded, want.sharded)
        same_streams(got.replicated, want.replicated)
        assert (got.bitmap_axis1, got.shard_leading, got.ng, got.patch_params) == (
            want.bitmap_axis1, want.shard_leading, want.ng, want.patch_params)
        assert (got.patch_streams is None) == (want.patch_streams is None)
        if want.patch_streams is not None:
            same_streams(got.patch_streams, want.patch_streams)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_decode_groups_and_take_match_jax(case):
    v, ref, col = column(case)
    ng = gtt.util.num_groups(col.n)
    slicer = partial.GroupSlicer(col, device="cpu")
    ranges = [(0, 1), (1, 3), (0, 3), (2, 3)] if ng == 3 else [(0, 1)]
    for g0, g1 in ranges:
        same_column(partial.slice_groups(col, g0, g1), jpartial.slice_groups(ref, g0, g1))
        got = slicer.decode(g0, g1)
        assert got.dtype == v.dtype and bits(got) == bits(partial.decode_ref_groups(col, g0, g1))
        assert bits(got) == bits(v[g0 * GROUP : g1 * GROUP])
    g0, g1 = ranges[1 % len(ranges)]
    assert bits(partial.decode_groups(col, g0, g1, device="cpu")) == bits(JAX(jax_decode_groups, ref, g0, g1))
    rng = rng_of(f"partial/take/{IDS[case]}")
    if col.n:
        idx = np.concatenate([rng.integers(0, col.n, 40), [0, col.n - 1, GROUP - 1, GROUP, 2 * GROUP + 7]])
        rng.shuffle(idx)
        got = partial.take(col, idx, device="cpu")
        assert got.dtype == v.dtype and bits(got) == bits(JAX(jax_take, ref, idx)) == bits(v[idx])
        shaped = partial.take(col, idx[:40].reshape(5, 8), device="cpu")
        assert shaped.shape == (5, 8) and bits(shaped) == bits(v[idx[:40]].reshape(5, 8))
        with pytest.raises(IndexError):
            partial.take(col, [col.n], device="cpu")
    assert partial.take(col, np.empty(0, np.int64), device="cpu").shape == (0,)


def test_take_touches_only_needed_groups(monkeypatch):
    """Three scattered points in a 40-group column decode a handful of
    (pow2-rounded) group ranges, never the whole column."""
    calls = []
    orig = partial.GroupSlicer.decode

    def spy(self, g0, g1):
        calls.append((g0, g1))
        return orig(self, g0, g1)

    monkeypatch.setattr(partial.GroupSlicer, "decode", spy)
    v = np.arange(40 * GROUP, dtype=np.int32) % 100000
    col = gtt.encode(v, "delta")
    idx = np.array([5, 3 * GROUP + 7, 30 * GROUP + 1])
    assert np.array_equal(partial.take(col, idx, device="cpu"), v[idx])
    assert sum(g1 - g0 for g0, g1 in calls) <= 6, calls


@pytest.mark.parametrize("kind", ["orderkey", "uint64", "float64"])
def test_wide_decode_groups_and_take_match_jax(kind):
    rng = rng_of(f"partial/wide/{kind}")
    v = wide_values(kind, N, rng)
    ref = gt.encode(v, "wide", base_scheme="delta" if kind == "orderkey" else "nbit")
    col = gtt.from_reference(ref)
    got = partial.decode_groups(col, 1, 3, device="cpu")
    assert got.dtype == v.dtype and bits(got) == bits(JAX(jax_decode_groups, ref, 1, 3)) == bits(v[GROUP:])
    idx = rng.integers(0, N, 64)
    assert bits(partial.take(col, idx, device="cpu")) == bits(JAX(jax_take, ref, idx)) == bits(v[idx])
    with pytest.raises(NotImplementedError, match="32-bit planes"):
        partial.GroupSlicer(col, device="cpu")


def test_nullable_slices_carry_their_validity_window():
    _, ref, col = column(IDS.index("delta-nulls"))
    sub = partial.slice_groups(col, 1, 3)
    assert sub.params["nullable"] and bits(sub.streams["valid"]) == bits(col.streams["valid"][1:3])
    same_column(sub, jpartial.slice_groups(ref, 1, 3))


def test_bad_ranges_are_rejected():
    col = gtt.encode(np.zeros(GROUP, np.int32), "nbit")
    for g0, g1 in ((1, 1), (0, 2), (-1, 1)):
        with pytest.raises(ValueError, match="out of"):
            partial.decode_groups(col, g0, g1, device="cpu")
    with pytest.raises(NotImplementedError, match="dist decode"):
        dist.dist_form(gtt.from_reference(gt.strings.encode_strings(["a", "b"])), 1)
