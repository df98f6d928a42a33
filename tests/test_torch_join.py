"""giddy_tpu_torch.join against giddy_tpu.join on the CPU, tolerance 0: the
pairs of ``join_indices`` must be equal in their order (left-major, right
partners in original right order, outer rows after the left-major block)
for inner, left and outer joins over int32, float32 (-0.0 and NaN keys,
matched on bit patterns), 64-bit (wide), dict, strdict and nullable keys;
``join_tables``, ``join_table`` and the Table methods give the same rows
and containers; ``anti_join_bitmap`` the same words. Both sides hold
n = 2·GROUP + 999 rows. The reference's answers are computed part by
part (a key kind, the table joins, the Table methods) in the worker's
reference process, each part once per run
(test_torch_inputs.ReferenceParts), so that no worker keeps any of its
interpret-mode programs. A larger join is held against
a NumPy sort-merge only."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu_torch import join, table
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import PRIORITIES, ReferenceParts, rng_of

N = 2 * GROUP + 999
CPU = "cpu"
KINDS = ["int32", "float32", "wide", "dict", "strdict", "nullable"]
HOWS = ("inner", "left", "outer")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def keys(kind: str, side: str, n: int = N):
    """(values, valid or None) of one join side: keys drawn from two
    overlapping ranges, so some rows match many partners and some none."""
    rng = rng_of(f"join/{kind}/{side}/{n}")
    lo, hi = (0, 3000) if side == "left" else (2000, 6000)
    v = rng.integers(lo, hi, n)
    valid = rng.random(n) > 0.1 if kind == "nullable" else None
    if kind == "float32":
        f = (v / 8.0).astype(np.float32)
        f[rng.integers(0, n, 30)] = np.array([0.0, -0.0, np.nan], np.float32)[rng.integers(0, 3, 30)]
        return f, None
    if kind == "wide":
        return v.astype(np.int64) * 2**33 - 2**40, None
    if kind == "dict":
        return (v % 700 + (0 if side == "left" else 400)).astype(np.int32), None
    if kind == "strdict":
        return np.array([f"{PRIORITIES[x % 5]}#{x}" for x in v], dtype=object), None
    return v.astype(np.int32), valid


def encode_pair(kind: str, side: str):
    """(values, valid, reference column, port column) of one join side,
    encoded on the host by the reference and copied into the port."""
    v, valid = keys(kind, side)
    if kind == "strdict":
        ref = gt.strings.encode_strings(list(v), name="key")
    elif kind == "wide":
        ref = gt.encode(v, "wide", name="key")
    else:
        scheme = {"float32": "raw", "dict": "dict"}.get(kind, "nbit")
        ref = gt.encode(v, scheme, name="key", valid=valid)
    return v, valid, ref, gtt.from_reference(ref)


def table_arrays(kind: str) -> tuple[dict, dict]:
    """Left and right arrays keyed on ``key``, each with a measure and, on
    the right, a nullable string column."""
    lv, lvalid = keys(kind, "left")
    rv, rvalid = keys(kind, "right")
    rng = rng_of(f"join/tables/{kind}")
    la = {"key": lv if lvalid is None else (lv, lvalid), "x": rng.integers(0, 1000, N).astype(np.int32)}
    ra = {"key": rv if rvalid is None else (rv, rvalid), "x": rng.integers(-50, 50, N).astype(np.int32),
          "s": (np.array([PRIORITIES[i] for i in rng.integers(0, 5, N)], dtype=object), rng.random(N) > 0.2)}
    return la, ra


def reference_part(part: str) -> dict:
    """The answers of giddy_tpu.join that this file compares with for one
    KINDS key, for "join_tables" or for "Table" (run in the worker's reference
    process)."""
    from giddy_tpu import join as jjoin
    from giddy_tpu import table as jtable

    out = {}
    if part in KINDS:
        lref, rref = encode_pair(part, "left")[2], encode_pair(part, "right")[2]
        for how in HOWS:
            out["pairs", how] = tuple(np.asarray(x) for x in jjoin.join_indices(lref, rref, how=how))
        out["anti"] = np.asarray(jjoin.anti_join_bitmap(lref, rref))
    elif part == "join_tables":
        rl, rr = (jtable.Table.from_arrays(a) for a in table_arrays("nullable"))
        for how in HOWS:
            rows, li, ri = jjoin.join_tables(rl, "key", rr, how=how)
            out["join_tables", how] = ({k: np.asarray(v) for k, v in rows.items()}, np.asarray(li), np.asarray(ri))
            out["join_table", how] = rl.join_table("key", rr, other_select=["s", "x"], how=how).to_bytes()
    elif part == "Table":
        rl, rr = (jtable.Table.from_arrays(a) for a in table_arrays("int32"))
        rows, li, ri = rl.join("key", rr, select=["x"], other_select=["s", "x"])
        out["Table.join"] = ({k: np.asarray(v) for k, v in rows.items()}, np.asarray(li), np.asarray(ri))
        for probe in ("key", "x"):
            out["Table.anti_join", probe] = np.asarray(rl.anti_join(probe, rr, "key"))
    else:
        raise ValueError(part)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """ref(part): the reference's answers of that part, computed once per
    run."""
    return ReferenceParts(tmp_path_factory, "join", reference_part)


def numpy_pairs(lv, lvalid, rv, rvalid, how: str):
    """The join's pairs in the reference's order, by a NumPy sort-merge."""
    def key(v):
        if v.dtype.kind == "f":
            return v.view(np.uint32 if v.dtype.itemsize == 4 else np.uint64)
        return np.array([str(x) for x in v]) if v.dtype == object else v

    lk, rk = key(lv), key(rv)
    lm = np.ones(len(lk), bool) if lvalid is None else lvalid
    rm = np.ones(len(rk), bool) if rvalid is None else rvalid
    ri_valid = np.flatnonzero(rm)
    order = ri_valid[np.argsort(rk[ri_valid], kind="stable")]
    srt = rk[order]
    lo, hi = np.searchsorted(srt, lk, "left"), np.searchsorted(srt, lk, "right")
    li, ri = [], []
    for i in range(len(lk)):
        part = order[lo[i]:hi[i]] if lm[i] else order[:0]
        if part.size:
            li.append(np.full(part.size, i))
            ri.append(part)
        elif how != "inner":
            li.append(np.array([i]))
            ri.append(np.array([-1]))
    li = np.concatenate(li).astype(np.int64) if li else np.empty(0, np.int64)
    ri = np.concatenate(ri).astype(np.int64) if ri else np.empty(0, np.int64)
    if how == "outer":
        un = np.setdiff1d(np.arange(len(rk)), ri)
        li, ri = np.concatenate([li, np.full(un.size, -1)]), np.concatenate([ri, un])
    return li, ri


@pytest.mark.parametrize("kind", KINDS)
def test_join_indices_pairs_equal_the_reference(ref, kind):
    lv, lvalid, _, lcol = encode_pair(kind, "left")
    rv, rvalid, _, rcol = encode_pair(kind, "right")
    want = ref(kind)
    for how in HOWS:
        got = join.join_indices(lcol, rcol, how=how, device=CPU)
        for g, w in zip(got, want["pairs", how]):
            assert g.dtype == np.int64 and np.array_equal(g, w), how
        np_li, np_ri = numpy_pairs(lv, lvalid, rv, rvalid, how)
        assert np.array_equal(got[0], np_li) and np.array_equal(got[1], np_ri), how
    assert got[0].size > N and (got[0] == -1).any() and (got[1] == -1).any()  # many-to-many, both outer sides
    anti = join.anti_join_bitmap(lcol, rcol, device=CPU).numpy().view(np.uint32)
    assert anti.tobytes() == want["anti"].tobytes()


def port_tables(kind: str):
    return tuple(table.Table.from_arrays(a, device=CPU) for a in table_arrays(kind))


def same_rows(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and (list(g) == list(w) if g.dtype == object else g.tobytes() == w.tobytes()), k


@pytest.mark.parametrize("how", HOWS)
def test_join_tables_and_join_table_equal_the_reference(ref, how):
    pl, pr = port_tables("nullable")
    rows, li, ri = join.join_tables(pl, "key", pr, how=how)
    want = ref("join_tables")
    wrows, wli, wri = want["join_tables", how]
    same_rows(rows, wrows)
    assert np.array_equal(li, wli) and np.array_equal(ri, wri)
    got = pl.join_table("key", pr, other_select=["s", "x"], how=how)
    assert got.device.type == "cpu" and got.to_bytes() == want["join_table", how]


def test_table_join_methods(ref):
    pl, pr = port_tables("int32")
    rows, li, ri = pl.join("key", pr, select=["x"], other_select=["s", "x"])
    want = ref("Table")
    wrows, wli, wri = want["Table.join"]
    same_rows(rows, wrows)
    assert list(rows) == ["x", "s", "x_r"] and np.array_equal(li, wli) and np.array_equal(ri, wri)
    for probe in ("key", "x"):
        assert pl.anti_join(probe, pr, "key").numpy().view(np.uint32).tobytes() == \
            want["Table.anti_join", probe].tobytes()
    # the prunes sharded over a mesh of four CPU shards: the same rows
    rows, li, ri = pl.join("key", pr, select=["x"], other_select=["s", "x"], mesh=gtt.dist.Mesh([CPU] * 4))
    same_rows(rows, wrows)
    assert np.array_equal(li, wli) and np.array_equal(ri, wri)


def test_empty_and_mismatched_sides():
    _, _, _, lcol = encode_pair("int32", "left")
    none = gtt.encode(np.full(N, 10**6, np.int32), "nbit", name="key")
    li, ri = join.join_indices(lcol, none, device=CPU)
    assert li.size == ri.size == 0
    li, ri = join.join_indices(lcol, none, how="left", device=CPU)
    assert np.array_equal(li, np.arange(N)) and (ri == -1).all()
    bm = join.anti_join_bitmap(lcol, gtt.encode(np.zeros(3, np.int32), "nbit", valid=np.zeros(3, bool)), device=CPU)
    assert gtt.query.count_bits(bm, N) == N  # an all-null build side matches nothing
    with pytest.raises(TypeError, match="string keys with numeric"):
        join._common_key_dtype(np.array([b"a"]), np.array([1]))
    with pytest.raises(TypeError, match="no exact common integer type"):
        join._common_key_dtype(np.array([1], np.int64), np.array([1], np.uint64))
    with pytest.raises(ValueError, match="how must be"):
        join.join_indices(lcol, lcol, how="cross", device=CPU)


def test_larger_join_against_numpy():
    """Left 9 groups, right 3 groups plus a few rows, dict-coded right keys
    (the dictionary-domain prune on the left's probe too)."""
    rng = rng_of("join/large")
    lv = rng.integers(0, 20_000, 9 * GROUP).astype(np.int32)
    rv = rng.integers(10_000, 40_000, 3 * GROUP + 5).astype(np.int32)
    lcol, rcol = gtt.encode(lv, "for"), gtt.encode(rv, "dict")
    for how in ("inner", "outer"):
        got = join.join_indices(lcol, rcol, how=how, device=CPU)
        want = numpy_pairs(lv, None, rv, None, how)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
