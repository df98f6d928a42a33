#!/usr/bin/env python
"""End-to-end demo on the PyTorch port: a TPC-H-flavored scan pipeline.

Generates an orders-like table, encodes it (advisor-picked schemes),
writes/reopens the container, and runs the whole query surface —
predicates, aggregates, GROUP BY, top-k, joins, partitioned datasets —
verifying every answer against NumPy. The same data, steps and printed
lines as examples/tpch_demo.py, on ``device`` (the card unless
``--device cpu`` is asked):

    python examples/tpch_demo_torch.py                 # the GPU
    python examples/tpch_demo_torch.py --device cpu    # the plain versions
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from giddy_tpu_torch.dataset import Dataset
from giddy_tpu_torch.table import Table


def orders_arrays(n: int, rng: np.random.Generator) -> tuple:
    """The orders table's columns (sorted dates, customer ids, skewed
    status), drawn from ``rng`` as examples/tpch_demo.py draws them."""
    order_date = np.sort(rng.integers(19_000, 20_000, n)).astype(np.int32)
    cust_id = rng.integers(0, 50_000, n).astype(np.int32)
    total = rng.gamma(2.0, 150.0, n).astype(np.float32)
    status = [["open", "shipped", "billed"][i]
              for i in rng.choice(3, n, p=[0.1, 0.6, 0.3])]
    return order_date, cust_id, total, status


def main(n: int = 1 << 20, device: torch.device | str = "cuda") -> None:
    rng = np.random.default_rng(42)

    # --- build an orders table (sorted dates, skewed status, 64-bit ids)
    order_date, cust_id, total, status = orders_arrays(n, rng)
    orders = Table.from_arrays({
        "date": order_date, "cust": cust_id, "total": total, "status": status,
    }, device=device)
    print("schemes:", {nm: orders[nm].scheme for nm in orders.names})

    # --- container round trip
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "orders.gtp")
        orders.save(path)
        orders = Table.open(path, device=device)

        # --- predicates fold into decode; only bitmaps leave the card
        d0, d1 = 19_200, 19_400
        want = int(((order_date >= d0) & (order_date < d1)).sum())
        got = orders.count(("date", "ge", d0), ("date", "lt", d1))
        assert got == want, (got, want)
        print(f"orders in window: {got}")

        # string predicates rewrite to code ranges on the dictionary
        sva = np.array(status, object)
        assert orders.count(("status", "eq", "shipped")) == int((sva == "shipped").sum())

        # --- exact fused aggregates (no decode materialization)
        s = orders.agg("total", "sum")
        assert abs(s - np.sum(total, dtype=np.float64)) < 1e-2
        print(f"revenue: {s:.2f}  (max order {orders.agg('total', 'max'):.2f})")

        # --- GROUP BY status
        r = orders.groupby("status", "total", ("count", "sum"))
        for j, k in enumerate(r.keys):
            sel = total[sva == k]
            assert r.count[j] == sel.size
        print("by status:", {str(k): int(c) for k, c in zip(r.keys, r.count)})

        # --- ORDER BY total DESC LIMIT 5, with row materialization
        vals, pos, rows = orders.top_k("total", 5, select=["date", "status"])
        assert np.allclose(vals, np.sort(total)[::-1][:5])
        print("top-5 orders:", [f"{v:.0f}" for v in vals])

        # --- join against a customers table (device prune, host pairs)
        segs = ["auto", "retail", "machinery"]
        cust = Table.from_arrays({
            "cust": np.arange(50_000, dtype=np.int32),
            "segment": [segs[i] for i in rng.integers(0, 3, 50_000)],
        }, device=device)
        joined, li, ri = Table([orders["cust"]], device=device).join("cust", cust,
                                                                     other_select=["segment"])
        assert li.size == n  # every order has exactly one customer
        print(f"join: {li.size} pairs")

        # --- semi/anti joins as bitmaps
        bm = orders.semi_join("cust", cust, "cust")
        from giddy_tpu_torch.query import count_bits

        assert count_bits(bm, n) == n

    # --- partitioned dataset: batches + zone-pruned scans
    with tempfile.TemporaryDirectory() as td:
        k = n // 4
        ds = Dataset.write(td, (
            Table.from_arrays({"date": order_date[i : i + k].copy(),
                               "total": total[i : i + k].copy()}, device=device)
            for i in range(0, n, k)
        ), device=device)
        plan = ds._plan([("date", "lt", int(order_date[k // 2]))])
        print("partition plan:", [v for _, v in plan])  # later partitions skip
        want = int((order_date < 19_500).sum())
        assert ds.count(("date", "lt", 19_500)) == want
        assert ds.agg("date", "min") == int(order_date.min())  # manifest, O(1)
        print(f"dataset: {ds.n_partitions} partitions, {len(ds)} rows")

    print("ALL DEMO CHECKS PASSED")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
