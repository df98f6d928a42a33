"""giddy_tpu_torch.groupby against giddy_tpu.groupby on the CPU, from the
same numpy-seeded key and measure columns: dict, cascade and strdict keys
(nullable ones and an explicit dictionary with empty groups), measures of
every 32-bit-or-narrower kind, float32 with NaN, wide int64/uint64/float64,
nullable measures, with and without a filter bitmap. Every GroupResult
field must be equal: keys, counts, sums (int64, float64 or Python-int
object arrays) and min/max, their dtypes and, for floats and empty groups,
their bits. The reference runs its segment ops over the Pallas decodes in
interpret mode, the port its torch ops over the plain kernel versions."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import groupby as jg
from giddy_tpu import query as jq
from giddy_tpu_torch import groupby, query
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import PRIORITIES, rng_of, scan_values, wide_values

N = 2 * GROUP + 999  # three groups, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def keys_column(kind: str, n: int = N):
    """(reference, port) key column: ``dict`` 40 int32 keys, ``cascade`` 13
    keys in runs (rle inner), ``strdict`` TPC-H's order priorities,
    ``explicit`` a cascade over a 6-entry dictionary of which 2 occur,
    ``dict-nulls`` the dict keys with 10% nulls."""
    rng = rng_of(f"groupby/keys/{kind}/{n}")
    if kind == "strdict":
        ref = gt.strings.encode_strings([PRIORITIES[i] for i in rng.integers(0, 5, n)], name="k")
    elif kind == "explicit":
        vocab = np.array([-5, 0, 5, 10, 77, 99], np.int32)
        ref = gt.encode(vocab[rng.integers(1, 3, n)], "cascade", dictionary=vocab)
    elif kind == "cascade":
        ref = gt.encode(np.repeat(rng.integers(-100, 100, 13)[rng.integers(0, 13, n // 40 + 1)], 40)[:n]
                        .astype(np.int32), "cascade")
    else:
        vocab = rng.integers(-(2**31), 2**31, 40, dtype=np.int64).astype(np.int32)
        valid = rng.random(n) > 0.1 if kind == "dict-nulls" else None
        ref = gt.encode(vocab[rng.integers(0, 40, n)], "dict", valid=valid)
    return ref, gtt.from_reference(ref)


def vals_column(kind: str, n: int = N):
    """(reference, port) measure column of ``kind`` = "<dtype>-<scheme>" or
    "wide-<dtype>", "-nulls" for 10% nulls."""
    rng = rng_of(f"groupby/vals/{kind}/{n}")
    valid = rng.random(n) > 0.1 if kind.endswith("-nulls") else None
    parts = kind.removesuffix("-nulls").split("-")
    if parts[0] == "wide":
        v = wide_values({"int64": "orderkey"}.get(parts[1], parts[1]), n, rng)
        ref = gt.encode(v, "wide", valid=valid, base_scheme="delta" if parts[1] == "int64" else "nbit")
    else:
        ref = gt.encode(scan_values(parts[0], n, rng), parts[1], valid=valid)
    return ref, gtt.from_reference(ref)


def same_array(got, want, what: str) -> None:
    if want is None:
        assert got is None, what
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    if want.dtype == object:
        assert all(type(a) is type(b) and a == b for a, b in zip(got, want)), what
    else:
        assert got.tobytes() == want.tobytes(), what


def same_result(got, want) -> None:
    for f in ("keys", "count", "sum", "min", "max"):
        same_array(getattr(got, f), getattr(want, f), f)


AGGS = ("count", "sum", "min", "max")
# (keys kind, measure kind)
CASES = [
    ("dict", "int32-nbit"), ("cascade", "int32-for"), ("strdict", "int32-delta"), ("dict", "int16-nbit"),
    ("dict", "int8-rle"), ("cascade", "uint32-nbit"), ("dict", "uint16-dzbf"), ("strdict", "float32-nbit"),
    ("dict-nulls", "int32-nbit-nulls"), ("explicit", "int32-rle"), ("dict", "wide-int64"),
    ("strdict", "wide-uint64"), ("cascade", "wide-float64"), ("dict-nulls", "wide-int64-nulls"),
]


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filtered"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{k}-{v}" for k, v in CASES])
def test_group_reduce_matches_jax(case, filtered):
    kk, vk = CASES[case]
    kref, kcol = keys_column(kk)
    vref, vcol = vals_column(vk)
    bm = jbm = None
    if filtered:  # a predicate over a third column of the same length
        fref = gt.encode(scan_values("int32", N, rng_of("groupby/filter")), "nbit")
        bm, jbm = query.filter_bitmap(gtt.from_reference(fref), "lt", 0, device="cpu"), jq.filter_bitmap(fref, "lt", 0)
    got = groupby.group_reduce(kcol, vcol, AGGS, bm, device="cpu")
    same_result(got, jg.group_reduce(kref, vref, AGGS, jbm))
    if case % 4 == 0:
        same_result(groupby.group_count(kcol, bm, device="cpu"), jg.group_count(kref, jbm))
        same_result(groupby.group_reduce(kcol, vcol, ("sum",), bm, device="cpu"),
                    jg.group_reduce(kref, vref, ("sum",), jbm))


def test_group_reduce_multi_matches_jax():
    (k1r, k1), (k2r, k2) = keys_column("strdict"), keys_column("dict-nulls")
    vref, vcol = vals_column("int32-for")
    got = groupby.group_reduce_multi([k1, k2], vcol, AGGS, device="cpu")
    same_result(got, jg.group_reduce_multi([k1r, k2r], vref, AGGS))
    same_result(groupby.group_reduce_multi([k1], vcol, ("count",), device="cpu"),
                jg.group_reduce_multi([k1r], vref, ("count",)))


def test_group_reduce_at_n_0():
    kref, kcol = keys_column("dict", 0)
    vref, vcol = vals_column("int32-nbit", 0)
    same_result(groupby.group_reduce(kcol, vcol, AGGS, device="cpu"), jg.group_reduce(kref, vref, AGGS))


def test_group_keys_and_arguments_are_checked():
    col = gtt.encode(np.zeros(10, np.int32), "nbit")
    with pytest.raises(ValueError, match="dict"):
        groupby.group_count(col, device="cpu")
    cascade = gtt.encode(np.zeros(10, np.int32), "cascade")
    with pytest.raises(ValueError, match="length mismatch"):
        groupby.group_reduce(cascade, gtt.encode(np.zeros(11, np.int32), "nbit"), ("sum",), device="cpu")
    with pytest.raises(ValueError, match="require a values column"):
        groupby.group_reduce(cascade, None, ("sum",), device="cpu")
    with pytest.raises(ValueError, match="agg must be one of"):
        groupby.group_reduce(cascade, col, ("median",), device="cpu")
    with pytest.raises(ValueError, match="at least one key column"):
        groupby.group_reduce_multi([], device="cpu")
