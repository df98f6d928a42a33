"""The generators against the TPC-H and SSB value rules, at small n."""

import datetime
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import datagen, dates
ROOT = pathlib.Path(__file__).resolve().parents[2]

CONFIGS = ROOT / "benchmark" / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def draw_all(cfg, seed, n):
    """Every column of ``cfg`` (resident or not), as datagen.build draws them."""
    gen = torch.Generator().manual_seed(datagen.torch_seed(seed))
    table = datagen.Table(n, "cpu", gen, cfg.get("orders"))
    for spec in cfg["columns"]:
        table.columns[spec["name"]] = datagen.generator(spec["generator"]).generate(table, spec.get("args", {}))
    return table


def retail_cents(pk):
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def test_tpch_lineitem_rules(rows):
    t = draw_all(config("tpch-sf100-lineitem-q6"), 7, rows)
    c = {k: v.numpy() for k, v in t.columns.items()}
    lines = t.lines_per_order().numpy()
    assert lines.sum() == rows and lines.min() >= 1 and lines[:-1].max() <= 7 and set(lines[:-1]) == set(range(1, 8))
    od = c["o_orderdate"]
    assert od.min() >= dates.day("1992-01-01") and od.max() <= dates.day("1998-08-02")
    starts = np.concatenate([[0], np.cumsum(lines)[:-1]])
    assert (np.repeat(od[starts], lines) == od).all()  # one date an order
    off = c["l_shipdate"] - od
    assert off.min() == 1 and off.max() == 121
    assert c["l_discount"].min() == 0 and c["l_discount"].max() == 10
    assert c["l_quantity"].min() == 1 and c["l_quantity"].max() == 50
    pk = c["l_partkey"]
    assert pk.min() >= 1 and pk.max() <= 20_000_000
    assert (c["l_extendedprice"] == c["l_quantity"] * retail_cents(pk)).all()
    assert c["l_extendedprice"].max() <= 10_495_000 and c["l_extendedprice"].min() >= 90_000


def test_ssb_lineorder_rules(rows):
    cfg = config("ssb-sf100-lineorder-q1")
    cols = {k: v.numpy() for k, v in datagen.build(cfg, 11, "cpu", rows).items()}
    assert list(cols) == ["lo_orderdate", "lo_discount", "lo_quantity", "lo_extendedprice"]
    od = cols["lo_orderdate"]
    assert (np.diff(od) >= 0).all()  # clustered
    parsed = {datetime.date(v // 10000, v // 100 % 100, v % 100) for v in np.unique(od).tolist()}
    assert min(parsed) >= datetime.date(1992, 1, 1) and max(parsed) <= datetime.date(1998, 8, 2)
    assert cols["lo_discount"].max() == 10 and cols["lo_quantity"].min() == 1
    assert cols["lo_extendedprice"].max() < 2**24
    # the non-date columns keep their draws' values, only reordered by date
    t = draw_all(cfg, 11, rows)
    for name in ("lo_discount", "lo_quantity", "lo_extendedprice"):
        assert np.array_equal(np.sort(cols[name]), np.sort(t.columns[name].numpy()))


@pytest.mark.parametrize("name", ["tpch-sf100-lineitem-q6", "ssb-sf100-lineorder-q1"])
def test_same_seed_same_table(name, rows):
    cfg = config(name)
    a = datagen.build(cfg, 2**31 + 12345, "cpu", rows)
    b = datagen.build(cfg, 2**31 + 12345, "cpu", rows)
    c = datagen.build(cfg, 2**31 + 12346, "cpu", rows)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(v.shape == (rows,) and v.dtype == torch.int32 for v in a.values())


def test_date_encodings_and_windows():
    assert dates.day("1970-01-02") == 1 and dates.yyyymmdd(dates.day("1994-02-28")) == 19940228
    t = torch.tensor([dates.day("1992-01-01"), dates.day("1998-08-02")], dtype=torch.int32)
    assert dates.encode(t, "yyyymmdd").tolist() == [19920101, 19980802]
    assert len(dates.windows("year", "1993-01-01", "1997-12-31")) == 5
    months = dates.windows("month", "1992-01-01", "1998-08-02")
    assert len(months) == 6 * 12 + 7 and months[-1][1] == dates.day("1998-07-31")
    weeks = dates.windows("week", "1992-01-01", "1998-08-02")
    assert all(b - a == 6 for a, b in weeks) and weeks[0][0] == dates.day("1992-01-01")
