"""giddy_tpu_torch.table against giddy_tpu.table on the CPU, tolerance 0.

One numpy-seeded table at n = 2·GROUP + 999 goes through both packages'
``Table.from_arrays`` (the advisor picks every scheme but the group key's):
an int32 measure, float32 prices with -0.0 and NaN, int64 timestamps
(wide), strings (strdict), a dict key and a nullable int32; a pandas frame
adds datetime64, bool, float64 with NaN, None strings and Int64 with NA.
Every result must equal the reference's: the containers byte for byte,
bitmaps word for word (pad bits included), counts, aggregates,
GroupResult fields, ``select``/``take``/``top_k`` rows, the containers of
``sort_by``/``filter`` results, and ``from_pandas``/``to_pandas`` frames.
The reference's answers are computed part by part in the worker's
reference process (test_torch_inputs.ReferenceParts), each part once per
run, so that no worker keeps any of its interpret-mode programs and no
part is computed twice; the port's Table lives on the CPU (``device="cpu"``) and
runs the kernels' plain versions."""

import numpy as np
import pandas as pd
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import table
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import PRIORITIES, ReferenceParts, rng_of

N = 2 * GROUP + 999
CPU = "cpu"
SCHEMES = {"k": "dict"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def arrays(n: int = N) -> dict:
    rng = rng_of(f"table/{n}")
    price = np.round(rng.uniform(0, 500, n), 2).astype(np.float32)
    price[rng.integers(0, n, 20)] = np.array([-0.0, np.nan], np.float32)[rng.integers(0, 2, 20)]
    return {
        "x": rng.integers(-(2**19), 2**19, n).astype(np.int32),
        "price": price,
        "ts": (1_700_000_000_000 + np.cumsum(rng.integers(0, 50, n))).astype(np.int64),
        "prio": np.array([PRIORITIES[i] for i in rng.integers(0, 5, n)], dtype=object),
        "k": rng.integers(0, 17, n).astype(np.int32) * 3,
        "nx": (rng.integers(0, 100, n).astype(np.int32), rng.random(n) > 0.15),
    }


def build_arrays() -> dict:
    rng = rng_of("table/build")
    return {"kk": {"kk": np.unique(rng.integers(0, 60, 20)).astype(np.int32)},
            "s": {"s": np.array(["2-HIGH", "5-LOW", "9-NONE"], dtype=object)}}


def frame(n: int = N) -> pd.DataFrame:
    rng = rng_of(f"table/pandas/{n}")
    df = pd.DataFrame({
        "i": rng.integers(-5, 5, n).astype(np.int64),
        "big": rng.integers(0, 2**40, n),
        "f": rng.normal(0, 1, n),
        "s": [PRIORITIES[i] for i in rng.integers(0, 5, n)],
        "t": pd.to_datetime(1_600_000_000 + rng.integers(0, 10**6, n), unit="s"),
        "b": rng.random(n) > 0.5,
    })
    df.loc[rng.integers(0, n, 40), "f"] = np.nan
    df["s"] = df["s"].astype(object)
    df.loc[rng.integers(0, n, 30), "s"] = None
    df["ni"] = pd.array(rng.integers(0, 9, n), dtype="Int64")
    df.loc[rng.integers(0, n, 25), "ni"] = pd.NA
    df.loc[rng.integers(0, n, 10), "t"] = pd.NaT
    return df


PREDICATES = [
    ("x", "lt", 0), ("x", "between", (-10, 500)), ("x", "isin", [3, -7, 999, 5000]),
    ("x", "isin", list(range(-40, 40, 3))), ("price", "ge", 250.0), ("price", "eq", -0.0),
    ("ts", "gt", 1_700_000_500_000), ("prio", "eq", "2-HIGH"), ("prio", "startswith", "3"),
    ("prio", "between", ("2", "4")), ("prio", "isin", ["1-URGENT", "5-LOW"]), ("k", "ge", 30),
    ("nx", "le", 40),
]
MULTI = [("prio", "eq", "3-MEDIUM"), ("nx", "ge", 10), ("x", "lt", 500)]
JOINS = (("k", "kk"), ("x", "kk"), ("nx", "kk"), ("prio", "s"))
TAKE = rng_of("table/take").integers(0, N, 300)
TOPK = (("x", True), ("price", False), ("ts", True))
AGGS = [("x", ("sum", "min", "max", "avg", "count", "distinct")), ("price", ("sum", "min", "max", "count", "distinct")),
        ("ts", ("sum", "min", "max", "count")), ("nx", ("sum", "min", "max", "avg", "count", "distinct")),
        ("prio", ("min", "max", "count", "distinct")), ("k", ("sum", "distinct"))]
GROUPBYS = (("k", "x", ("count", "sum", "min", "max"), ()), ("prio", "nx", ("count", "sum"), (("x", "ge", 0),)),
            (["prio", "k"], "x", ("count", "max"), ()))
SORTS = ((["k", "price"], [True, False]), ("prio", True), (["nx", "ts"], False))
FILTER = (("prio", "eq", "1-URGENT"), ("x", "lt", 0))


def group_fields(r) -> dict:
    return {f: None if getattr(r, f) is None else np.asarray(getattr(r, f)) for f in ("keys", "count", "sum", "min", "max")}


_REFERENCE = {}  # in the reference process: the reference's table, built once


def reference_part(part: str, *args) -> dict:
    """One part of giddy_tpu.table's answers that this file compares with
    (run in the worker's reference process)."""
    from giddy_tpu import table as jtable

    if not _REFERENCE:
        _REFERENCE["t"] = jtable.Table.from_arrays(arrays(), SCHEMES)
    t, out = _REFERENCE["t"], {}
    if part == "container":
        out["bytes"], out["schemes"] = t.to_bytes(), [t[nm].scheme for nm in t.names]
        out["count x lt 0"] = t.count(("x", "lt", 0))
    elif part == "where":
        out["where"] = np.asarray(t.where(*PREDICATES[args[0]]))
    elif part == "where_all":
        out["where_all"], out["where_any"] = np.asarray(t.where_all(*MULTI)), np.asarray(t.where_any(*MULTI))
        out["count"], out["count k"] = t.count(*MULTI), t.count(("k", "eq", 9))
    elif part == "joins":
        build = {k: jtable.Table.from_arrays(a) for k, a in build_arrays().items()}
        for probe, other in JOINS:
            out["semi", probe] = np.asarray(t.semi_join(probe, build[other], other))
            out["anti", probe] = np.asarray(t.anti_join(probe, build[other], other))
    elif part == "select":
        bm = t.where("x", "ge", 900)
        out["bm x ge 900"] = np.asarray(bm)
        out["select bm"] = t.select(["x", "price", "ts", "prio", "nx"], bm)
        out["select preds"] = t.select(["k", "prio"], None, ("nx", "lt", 3), ("x", "gt", 0))
        out["select bm preds"] = t.select(["x"], bm, ("k", "lt", 20))
        out["take"] = {nm: t.take(nm, TAKE) for nm in t.names}
        for name, largest in TOPK:
            vals, pos, rows = t.top_k(name, 7, largest=largest, select=["prio", "k"])
            out["top_k", name] = (np.asarray(vals), np.asarray(pos), rows)
    elif part == "agg":
        out.update((agg, t.agg(args[0], agg)) for agg in dict(AGGS)[args[0]])
    elif part == "groupby":
        for i, (keys, vals, aggs, preds) in enumerate(GROUPBYS):
            out["groupby", i] = group_fields(t.groupby(keys, vals, aggs, *preds))
        for nm in ("k", "prio", "x", "price"):
            out["distinct", nm] = t.distinct(nm)
        out["distinct multi"] = t.distinct(["prio", "k"])
    elif part == "sort":
        for i, (names, asc) in enumerate(SORTS):
            out["sort_by", i] = t.sort_by(names, ascending=asc).to_bytes()
        out["filter"] = t.filter(*FILTER).to_bytes()
    elif part == "pandas":
        df = frame()
        pt = jtable.Table.from_pandas(df)
        out["pandas bytes"], out["to_pandas"] = pt.to_bytes(), pt.to_pandas()
        out["to_pandas bm"] = pt.to_pandas(pt.where("i", "ge", 0), ("ni", "lt", 5))
        out["pandas pinned"] = jtable.Table.from_pandas(df, dtypes={"i": "int16"}).to_bytes()
    else:
        raise ValueError(part)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """ref(part, *args): that part of the reference's answers, computed
    once per run."""
    return ReferenceParts(tmp_path_factory, "table", reference_part)


@pytest.fixture(scope="module")
def port():
    return table.Table.from_arrays(arrays(), SCHEMES, device=CPU)


def words(bm) -> np.ndarray:
    return bm.cpu().numpy().view(np.uint32) if isinstance(bm, torch.Tensor) else np.asarray(bm)


def same_words(got, want) -> None:
    g, w = words(got), words(want)
    assert g.shape == w.shape and g.tobytes() == w.tobytes()


def same_rows(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == object:
            assert list(g) == list(w), k
        else:
            assert g.tobytes() == w.tobytes(), k


def test_from_arrays_writes_the_reference_container(ref, port):
    want = ref("container")
    assert port.n == N and port.to_bytes() == want["bytes"]
    assert [port[nm].scheme for nm in port.names] == want["schemes"]


@pytest.mark.parametrize("i", range(len(PREDICATES)), ids=[f"{p[0]}-{p[1]}" for p in PREDICATES])
def test_where_bitmaps_equal_the_reference(ref, port, i):
    got = port.where(*PREDICATES[i])
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    same_words(got, ref("where", i)["where"])


def test_where_all_any_count(ref, port):
    want = ref("where_all")
    same_words(port.where_all(*MULTI), want["where_all"])
    same_words(port.where_any(*MULTI), want["where_any"])
    assert port.count(*MULTI) == want["count"] and port.count(("k", "eq", 9)) == want["count k"]
    with pytest.raises(ValueError):
        port.where_all()


def test_semi_and_anti_join_bitmaps(ref, port):
    build = {k: table.Table.from_arrays(a, device=CPU) for k, a in build_arrays().items()}
    want = ref("joins")
    for probe, other in JOINS:
        same_words(port.semi_join(probe, build[other], other), want["semi", probe])
        same_words(port.anti_join(probe, build[other], other), want["anti", probe])


def test_select_take_and_top_k(ref, port):
    want = ref("select")
    bm = port.where("x", "ge", 900)
    same_words(bm, want["bm x ge 900"])
    same_rows(port.select(["x", "price", "ts", "prio", "nx"], bm), want["select bm"])
    same_rows(port.select(["k", "prio"], None, ("nx", "lt", 3), ("x", "gt", 0)), want["select preds"])
    # a NumPy bitmap ANDed with predicates
    same_rows(port.select(["x"], want["bm x ge 900"], ("k", "lt", 20)), want["select bm preds"])
    same_rows({nm: port.take(nm, TAKE) for nm in port.names}, want["take"])
    for name, largest in TOPK:
        gv, gp, grows = port.top_k(name, 7, largest=largest, select=["prio", "k"])
        wv, wp, wrows = want["top_k", name]
        assert gv.tobytes() == wv.tobytes() and np.array_equal(gp, wp)
        same_rows(grows, wrows)


@pytest.mark.parametrize("name,aggs", AGGS)
def test_agg_equals_the_reference(ref, port, name, aggs):
    wants = ref("agg", name)
    for agg in aggs:
        got, want = port.agg(name, agg), wants[agg]
        assert type(got) is type(want) or isinstance(got, float) and isinstance(want, float), (agg, got, want)
        assert (np.isnan(got) and np.isnan(want)) if isinstance(got, float) and np.isnan(want) else got == want, agg
    with pytest.raises(ValueError):
        port.agg(name, "median")


def same_group(got, want: dict) -> None:
    for field, w in want.items():
        g = getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert list(g) == list(w) if g.dtype == object else g.tobytes() == w.tobytes(), field


def test_groupby_and_distinct(ref, port):
    wants = ref("groupby")
    for i, (keys, vals, aggs, preds) in enumerate(GROUPBYS):
        same_group(port.groupby(keys, vals, aggs, *preds), wants["groupby", i])
    for nm in ("k", "prio", "x", "price"):
        got, want = port.distinct(nm), wants["distinct", nm]
        assert len(got) == len(want) and np.array(got).tobytes() == np.array(want).tobytes(), nm
    assert port.distinct(["prio", "k"]) == wants["distinct multi"]


def test_sort_by_and_filter_write_the_reference_containers(ref, port):
    want = ref("sort")
    for i, (names, asc) in enumerate(SORTS):
        got = port.sort_by(names, ascending=asc)
        assert got.device.type == "cpu" and got.to_bytes() == want["sort_by", i]
    assert port.filter(*FILTER).to_bytes() == want["filter"]
    with pytest.raises(ValueError, match="no rows"):
        port.filter(("x", "gt", 10**6))


def test_container_round_trip(ref, port, tmp_path):
    port.save(tmp_path / "t.gtp")
    again = table.Table.open(str(tmp_path / "t.gtp"), device=CPU)
    want = ref("container")
    assert again.to_bytes() == port.to_bytes() == want["bytes"]
    assert table.Table.read(want["bytes"], device=CPU).count(("x", "lt", 0)) == want["count x lt 0"]


def test_pandas_round_trip_equals_the_reference(ref):
    df = frame()
    port, want = table.Table.from_pandas(df, device=CPU), ref("pandas")
    assert port.to_bytes() == want["pandas bytes"]
    pd.testing.assert_frame_equal(port.to_pandas(), want["to_pandas"])
    pd.testing.assert_frame_equal(port.to_pandas(port.where("i", "ge", 0), ("ni", "lt", 5)), want["to_pandas bm"])
    assert table.Table.from_pandas(df, dtypes={"i": "int16"}, device=CPU).to_bytes() == want["pandas pinned"]


def test_construction_errors_and_device():
    c = gtt.encode(np.arange(5, dtype=np.int32), "nbit", name="a")
    with pytest.raises(ValueError, match="at least one column"):
        table.Table([])
    with pytest.raises(ValueError, match="duplicate"):
        table.Table([c, c])
    with pytest.raises(ValueError, match="expected"):
        table.Table([c, gtt.encode(np.arange(6, dtype=np.int32), "nbit", name="b")])
    t = table.Table([c])
    assert t.device.type == "cuda" and len(t) == 5 and t["a"] is c
    with pytest.raises(KeyError, match="no column"):
        t["zz"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.count(("a", "lt", 3))
