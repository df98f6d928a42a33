"""giddy_tpu_torch.dataset against giddy_tpu.dataset on the CPU, tolerance
0. The on-disk format is shared: the same numpy-seeded partitions written
by either package give the same manifest text and the same partition
bytes, and a dataset written by one package opens in the other with equal
``_plan`` verdicts ("skip"/"all"/"scan", nullable partitions and float
total order included), ``count``, ``agg``, ``groupby``, ``select`` and
``to_pandas``. Three partitions of 2·GROUP + 999 rows: a dict group key, an
int32 measure whose ranges do not overlap (so the zones prune), float32
with -0.0 and a NaN partition (its zone is left out), strings (strdict),
an int64 column (wide) and a nullable int32 that is all null in one
partition. The reference writes and reads its side once per run
(test_torch_inputs.once_per_run), in the worker's reference process, so
that no worker keeps any of its interpret-mode programs."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import dataset, table
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX, PRIORITIES, once_per_run, rng_of

N = 2 * GROUP + 999
CPU = "cpu"
SCHEMES = {"k": "dict"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def partition(i: int) -> dict:
    rng = rng_of(f"dataset/{i}")
    f = (rng.integers(-50, 50, N) / 4.0).astype(np.float32)
    f[rng.integers(0, N, 10)] = -0.0
    if i == 1:
        f[7] = np.nan
    valid = np.zeros(N, bool) if i == 2 else rng.random(N) > 0.2
    return {
        "k": rng.integers(0, 9, N).astype(np.int32),
        "x": (rng.integers(0, 1000, N) + 1000 * i).astype(np.int32),
        "f": f,
        "s": np.array([PRIORITIES[j] for j in rng.integers(0, 5, N)], dtype=object),
        "big": (rng.integers(0, 2**20, N) + (i << 40)).astype(np.int64),
        "nx": (rng.integers(0, 50, N).astype(np.int32), valid),
    }


def frame() -> pd.DataFrame:
    rng = rng_of("dataset/csv")
    n = GROUP + 500
    df = pd.DataFrame({"a": rng.integers(0, 100, n), "b": rng.normal(0, 1, n),
                       "c": [PRIORITIES[i] for i in rng.integers(0, 5, n)]})
    df.loc[rng.integers(0, n, 20), "b"] = np.nan
    return df


PREDICATES = [
    [("x", "lt", 1000)], [("x", "ge", 1000), ("x", "le", 1999)], [("x", "between", (500, 2500))],
    [("x", "isin", [5, 2999])], [("x", "isin", [1500])], [("x", "eq", 10**10)], [("x", "ne", 77)],
    [("f", "lt", 0.0)], [("f", "ge", -0.0)], [("f", "lt", float("inf"))], [("big", "ge", 2 << 40)],
    [("nx", "ge", 0)], [("nx", "lt", 10), ("x", "lt", 2000)], [("s", "eq", "2-HIGH")], [("k", "eq", 3)],
]
AGGS = (("x", ("sum", "min", "max", "avg", "count", "distinct")), ("f", ("min", "max", "count")),
        ("big", ("min", "max", "sum")), ("nx", ("sum", "min", "max", "count")),
        ("s", ("min", "max", "count", "distinct")))
GROUPBYS = (("k", "x", ("count", "sum", "min", "max"), ()), ("s", "nx", ("count", "sum"), (("x", "ge", 1500),)),
            (["s", "k"], "x", ("count", "max"), ()))
SELECTS = ((("x", "ge", 2990),), (("x", "gt", 10**6),), ())


def outcome(fn, *args):
    """fn's result, or the type of the ValueError it raises (min/max over
    a partition whose column is all null raise in both packages)."""
    try:
        return fn(*args)
    except ValueError:
        return ValueError


def answers(ds) -> dict:
    """A dataset's answers to this file's queries, in either package."""
    out = {}
    for i, preds in enumerate(PREDICATES):
        out["plan", i], out["count", i] = ds._plan(preds), ds.count(*preds)
    out["len"], out["names"], out["n_partitions"] = len(ds), ds.names, ds.n_partitions
    for name, aggs in AGGS:
        for agg in aggs:
            out["agg", name, agg] = outcome(ds.agg, name, agg)
    for i, (keys, vals, aggs, preds) in enumerate(GROUPBYS):
        r = ds.groupby(keys, vals, aggs, *preds)
        out["groupby", i] = {f: None if getattr(r, f) is None else np.asarray(getattr(r, f))
                             for f in ("keys", "count", "sum", "min", "max")}
    for i, preds in enumerate(SELECTS):
        out["select", i] = ds.select(["x", "s", "big"], *preds)
    out["to_pandas"] = ds.to_pandas(("x", "lt", 1100))
    return out


def reference_results(root: str) -> dict:
    """giddy_tpu.dataset's side (run in the reference process): it writes
    ``root/ref``, answers on both datasets, compacts the port's into
    ``root/ref_compact`` and builds ``root/ref_pandas`` and ``root/ref_csv``
    from frame() and ``root/in.csv``."""
    from giddy_tpu import dataset as jds
    from giddy_tpu import table as jtable

    jds.Dataset.write(f"{root}/ref", [jtable.Table.from_arrays(partition(i), SCHEMES) for i in range(3)])
    out = {w: answers(jds.Dataset.open(f"{root}/{w}")) for w in ("ref", "port")}
    compacted = jds.Dataset.open(f"{root}/port").compact(f"{root}/ref_compact", rows_per_partition=GROUP * 4)
    out["compact"] = (compacted.n_partitions, compacted.count(("x", "lt", 500)))
    for kind in ("pandas", "csv"):
        if kind == "pandas":
            ds = jds.Dataset.from_pandas(f"{root}/ref_pandas", frame(), rows_per_partition=GROUP)
        else:
            ds = jds.Dataset.from_csv(f"{root}/ref_csv", f"{root}/in.csv", rows_per_partition=GROUP)
        out[kind] = (ds.manifest, [ds.part(i).to_bytes() for i in range(ds.n_partitions)])
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The port writes ``root/port``; the reference then writes ``root/ref``
    and answers on both: (root, the reference's answers)."""
    def compute(root):
        dataset.Dataset.write(str(root / "port"), [table.Table.from_arrays(partition(i), SCHEMES, device=CPU)
                                                   for i in range(3)], device=CPU)
        frame().to_csv(root / "in.csv", index=False)
        return JAX(reference_results, str(root))

    return once_per_run(tmp_path_factory, "datasets", compute)


def test_both_packages_write_the_same_files(written):
    root, _ = written
    names = sorted(os.listdir(root / "ref"))
    assert names == sorted(os.listdir(root / "port")) == ["manifest.json"] + [f"part-{i:05d}.gtp" for i in range(3)]
    for name in names:
        assert (root / "ref" / name).read_bytes() == (root / "port" / name).read_bytes(), name
    m = json.loads((root / "port" / "manifest.json").read_text())
    assert "f" not in m["partitions"][1]["zones"] and "nx" not in m["partitions"][2]["zones"]


@pytest.mark.parametrize("preds", range(len(PREDICATES)),
                         ids=[" & ".join(f"{n} {o}" for n, o, _ in p) for p in PREDICATES])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_plan_and_count_equal_across_packages(written, writer, preds):
    root, ref = written
    p = dataset.Dataset.open(str(root / writer), device=CPU)
    assert p._plan(PREDICATES[preds]) == ref[writer]["plan", preds]
    assert p.count(*PREDICATES[preds]) == ref[writer]["count", preds]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_agg_groupby_select_equal_across_packages(written, writer):
    root, ref = written
    want = ref[writer]
    got = answers(dataset.Dataset.open(str(root / writer), device=CPU))
    assert (got["len"], got["names"], got["n_partitions"]) == (want["len"], want["names"], want["n_partitions"])
    assert got["len"] == 3 * N
    for name, aggs in AGGS:
        for agg in aggs:
            g, w = got["agg", name, agg], want["agg", name, agg]
            assert type(g) is type(w) and (g == w or g != g and w != w), (name, agg)
    for i in range(len(GROUPBYS)):
        for field, w in want["groupby", i].items():
            g = got["groupby", i][field]
            assert (g is None) == (w is None), field
            if w is not None:
                assert g.dtype == w.dtype and g.tolist() == w.tolist(), field
    for i in range(len(SELECTS)):
        for k, w in want["select", i].items():
            g = got["select", i][k]
            assert g.dtype == w.dtype and g.tolist() == w.tolist(), k
    pd.testing.assert_frame_equal(got["to_pandas"], want["to_pandas"])


def test_compact_and_append(written, tmp_path):
    root, ref = written
    p = dataset.Dataset.open(str(root / "port"), device=CPU)
    got = p.compact(str(tmp_path / "p"), rows_per_partition=GROUP * 4)
    assert (got.n_partitions, got.count(("x", "lt", 500))) == ref["compact"] and got.n_partitions == 2
    for name in os.listdir(root / "ref_compact"):
        assert (tmp_path / "p" / name).read_bytes() == (root / "ref_compact" / name).read_bytes(), name
    with pytest.raises(ValueError, match="different directory"):
        p.compact(str(root / "port"))
    extra = table.Table.from_arrays(partition(0), SCHEMES, device=CPU)
    got.append(extra)
    assert dataset.Dataset.open(str(tmp_path / "p"), device=CPU).count(("x", "lt", 500)) == \
        got.count(("x", "lt", 500)) == ref["compact"][1] * 2
    bad = dict(partition(0), x=partition(0)["x"].astype(np.int16))
    with pytest.raises(ValueError, match="dataset expects"):
        got.append(table.Table.from_arrays(bad, SCHEMES, device=CPU))
    with pytest.raises(FileExistsError):
        dataset.Dataset.write(str(tmp_path / "p"), [extra], device=CPU)


def test_from_pandas_and_csv(written, tmp_path):
    root, ref = written
    for kind in ("pandas", "csv"):
        if kind == "pandas":
            got = dataset.Dataset.from_pandas(str(tmp_path / "p1"), frame(), rows_per_partition=GROUP, device=CPU)
        else:
            got = dataset.Dataset.from_csv(str(tmp_path / "p2"), str(root / "in.csv"), rows_per_partition=GROUP,
                                           device=CPU)
        manifest, parts = ref[kind]
        assert got.manifest == manifest and got.n_partitions == len(parts) == 2
        assert [got.part(i).to_bytes() for i in range(2)] == parts


def test_prune_rules():
    assert dataset._prune([0, 9], "lt", 0) == "skip" and dataset._prune([0, 9], "lt", 10) == "all"
    assert dataset._prune([5, 5], "eq", 5) == "all" and dataset._prune([5, 5], "ne", 5) == "skip"
    assert dataset._prune(None, "lt", 3) == dataset._prune([0, 1], "lt", None) == "scan"
    assert dataset._prune([0, 1], "lt", b"x") == "scan"
    assert dataset._stage("int8", 300) is None and dataset._stage("str", 1) is None
    assert dataset._stage("float32", -0.0) < dataset._stage("float32", 0.0)
    assert dataset._zone_keys("float32", [-0.0, 0.0]) == [dataset._stage("float32", -0.0), dataset._stage("float32", 0.0)]
    assert gtt.Dataset is dataset.Dataset
