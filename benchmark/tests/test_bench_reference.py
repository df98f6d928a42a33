"""The plain reference against a direct NumPy count, and its control."""

import json
import pathlib

import numpy as np
import torch

from benchmark import reference
from benchmark.runners import query as workload
from benchmark.runners.query import Predicate, Query
ROOT = pathlib.Path(__file__).resolve().parents[2]


def numpy_count(cols, where):
    m = np.ones(len(next(iter(cols.values()))), bool)
    for p in where:
        v = cols[p.column]
        if p.op == "between":
            m &= (v >= p.low) & (v <= p.high)
        else:
            m &= {"lt": np.less, "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
                  "eq": np.equal, "ne": np.not_equal}[p.op](v, p.value)
    return int(m.sum())


def test_counts_match_numpy():
    rng = np.random.default_rng(3)
    cols = {"a": rng.integers(0, 11, 50_000).astype(np.int32), "b": rng.integers(8000, 10600, 50_000).astype(np.int32)}
    tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
    queries = []
    for op in ("lt", "le", "gt", "ge", "eq", "ne"):
        for _ in range(3):
            queries.append(Query("t", (Predicate("a", op, value=int(rng.integers(0, 11))),
                                       Predicate("b", "between", low=int(rng.integers(8000, 9000)), high=int(rng.integers(9000, 10600))))))
    queries += queries[:4]  # repeats are worked out once and answered alike
    assert reference.counts(tcols, queries) == [numpy_count(cols, q.where) for q in queries]


def test_drawn_queries_follow_the_mix():
    mix = json.loads((ROOT / "benchmark" / "traffic" / "q6.json").read_text())
    qs = workload.draw_queries(mix, {"l_shipdate": "days_since_1970", "l_discount": None, "l_quantity": None}, 5, 400)
    assert qs == workload.draw_queries(mix, {"l_shipdate": "days_since_1970", "l_discount": None, "l_quantity": None}, 5, 400)
    for q in qs:
        ge, lt, disc, qty = q.where
        assert ge.op == "ge" and lt.op == "lt" and lt.value - ge.value in (365, 366)
        assert 1993 <= 1970 + ge.value // 365.25 < 1998
        assert 1 <= disc.low and disc.high == disc.low + 2 <= 10 and qty.value in (24, 25)
    mix = json.loads((ROOT / "benchmark" / "traffic" / "q1.json").read_text())
    qs = workload.draw_queries(mix, {"lo_orderdate": "yyyymmdd", "lo_discount": None, "lo_quantity": None}, 5, 300)
    assert [q.template for q in qs[:4]] == ["q1.1", "q1.2", "q1.3", "q1.1"]
    spans = {q.template: q.where[0].high - q.where[0].low for q in qs}
    assert spans["q1.1"] == 1130 and spans["q1.3"] < 31  # yyyymmdd: Jan 1 .. Dec 31; a week


def test_float16_control_breaks_the_guarantees():
    dates = torch.arange(8036, 10562, dtype=torch.int32).repeat(20)
    assert not torch.equal(reference.decode(dates, torch.float16), dates)
    cols = {"d": dates}
    q = (Predicate("d", "ge", value=8401), Predicate("d", "lt", value=8766))
    assert reference.count(cols, q, torch.float16) != reference.count(cols, q)
