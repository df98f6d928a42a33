"""K19's plain version (kernels/lanes.run_filter) and its route through
query.filter_bitmap, on the CPU: the bitmap of a predicate on an rle or
rpe column's tile-form run tables equals the general path's (K5's plain
decode, the compare, lanes.pack_hits) word for word, pad bits included
(tolerance 0), and its counts equal the NumPy oracle's. The kernel itself
is held against the same general path on the card by test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import api, kernels, nulls, query
from giddy_tpu_torch.kernels import lanes, run_filter
from giddy_tpu_torch.util import GROUP, LANES, np_dtype, num_groups

from test_torch_inputs import (
    OPS, RUN_TABLE_CASES, SCAN_DTYPES, rng_of, run_table_values, run_tables, scan_key, scan_runs, scan_thresholds,
    want_mask,
)

N = 2 * GROUP + 999  # three groups, the last one ragged
W_PADS = [8, 16, 32, 128]
TILES = [1, 2, 4, 8, 16, 32, 64]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def general_words(ends: torch.Tensor, vals: torch.Tensor, ng: int, kind: str, itemsize: int, op: str,
                  key: int) -> torch.Tensor:
    """The general path's words: decode (K5's plain version), compare, pack."""
    return lanes.pack_hits(query._cmp(lanes.run_expand(ends, vals, ng), key, op, kind, itemsize))


@pytest.mark.parametrize("dtype", SCAN_DTYPES)
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("w_pad", W_PADS)
def test_run_filter_matches_general_path(w_pad, tiles, dtype):
    """Every hand-made table (test_torch_inputs.run_tables: equal ends,
    ends of 0, runs of one, ends across 1024, all-pad tiles, ends outside
    [0, W]) of three groups, the last one's second half of tiles all pad,
    at every op against the dtype's thresholds: word for word."""
    dt = np_dtype(dtype)
    for case in RUN_TABLE_CASES:
        ends, _ = run_tables(case, w_pad, tiles, 3, seed=w_pad + tiles)
        vals, v = run_table_values(dtype, ends.shape, rng_of(f"run_filter/{case}/{w_pad}/{tiles}/{dtype}"))
        e, u = torch.from_numpy(ends), torch.from_numpy(vals)
        for op in OPS:
            for value in scan_thresholds(dtype, v):
                key = query._stage_key(dtype, value)
                got = run_filter.run_filter(e, u, None, 3, dt.kind, dt.itemsize, op, key)
                assert got.shape == (3, LANES) and got.dtype == torch.int32
                assert torch.equal(got, general_words(e, u, 3, dt.kind, dt.itemsize, op, key)), (case, op, value)


def run_column(scheme: str, dtype: str, nullable: bool, n: int = N):
    """(values, validity or None, column) in the tile form, the last group ragged."""
    rng = rng_of(f"run_filter/column/{scheme}/{dtype}/{nullable}")
    v = scan_runs(dtype, n, rng)
    valid = rng.random(n) > 0.1 if nullable else None
    return v, valid, gtt.encode(v, scheme, valid=valid)


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("dtype", SCAN_DTYPES)
@pytest.mark.parametrize("scheme", ["rle", "rpe"])
def test_filter_bitmap_of_run_columns(scheme, dtype, nullable):
    """query.filter_bitmap on rle and rpe columns in tile form: the words
    equal the general path's on the same streams (validity ANDed in), and
    count_where and count_between equal the oracle's."""
    v, valid, col = run_column(scheme, dtype, nullable)
    streams = api.device_streams(col, "cpu")
    assert "vals_w" in streams
    ng, dt = num_groups(col.n), np_dtype(col.dtype)
    w_pad = streams["vals_w"].shape[-1]
    ends, vals = streams["ends_w"].reshape(-1, w_pad), streams["vals_w"].reshape(-1, w_pad)
    vw = nulls.valid_words_device(col, "cpu") if nullable else None
    for op in OPS:
        for value in scan_thresholds(dtype, v):
            want = general_words(ends, vals, ng, dt.kind, dt.itemsize, op, query._stage_key(col.dtype, value))
            got = query.filter_bitmap(col, op, value, device="cpu")
            assert torch.equal(got, want if vw is None else want & vw), (op, value)
            assert query.count_where(col, op, value, device="cpu") == int(want_mask(v, op, value, valid).sum())
    lo, hi = sorted((v[len(v) // 3], v[2 * len(v) // 3]), key=lambda x: scan_key(np.array([x]))[0])
    want = want_mask(v, "ge", lo.item(), valid) & want_mask(v, "le", hi.item())
    assert query.count_between(col, lo.item(), hi.item(), device="cpu") == int(want.sum())


@pytest.mark.parametrize("form", ["tile", "scatter"])
@pytest.mark.parametrize("scheme", ["rle", "rpe"])
def test_stream_form_picks_the_route(monkeypatch, scheme, form):
    """The tile form's run tables go to run_filter, one call a predicate;
    the scatter form (runs of ~2, too dense for tiles) takes the general
    path. No flag: the streams decide."""
    calls = []

    def recording(*args):
        calls.append(args[3])
        return run_filter.run_filter(*args)

    monkeypatch.setattr(query, "run_filter", recording)
    rng = rng_of(f"run_filter/route/{scheme}/{form}")
    run = 300 if form == "tile" else 2
    v = np.repeat(rng.integers(-50, 50, N // run + 1), run)[:N].astype(np.int32)
    col = gtt.encode(v, scheme)
    assert ("vals_w" in api.device_streams(col, "cpu")) == (form == "tile")
    for op in OPS:
        assert query.count_where(col, op, 7, device="cpu") == int(want_mask(v, op, 7).sum())
    assert query.count_between(col, -10, 10, device="cpu") == int(((v >= -10) & (v <= 10)).sum())
    assert calls == ([num_groups(N)] * (len(OPS) + 2) if form == "tile" else [])


def test_run_filter_launches_nothing_on_the_cpu():
    """The CPU takes the plain version: no launch is counted, K19's or K5's."""
    kernels.reset_launches()
    ends, vals = run_tables("random", 32, 4, 2)
    run_filter.run_filter(torch.from_numpy(ends), torch.from_numpy(vals), None, 2, "i", 4, "lt", 0)
    _, _, col = run_column("rle", "int32", False)
    query.count_where(col, "lt", 0, device="cpu")
    assert kernels.launches()["run_filter"] == 0 and kernels.launches()["run_expand"] == 0


@pytest.mark.parametrize("bad", ["tiles", "w_pad", "rows", "op", "key", "kind", "valid"])
def test_run_filter_rejects_what_it_does_not_take(bad):
    ends, vals = run_tables("random", 16, 4, 2)
    e, u = torch.from_numpy(ends), torch.from_numpy(vals)
    args = {"ends_w": e, "vals_w": u, "valid": None, "ng": 2, "kind": "i", "itemsize": 4, "op": "lt", "key": 0}
    args.update({
        "tiles": {"ng": 3},  # 8 tables over 3 groups
        "w_pad": {"ends_w": e[:, :12].contiguous(), "vals_w": u[:, :12].contiguous()},
        "rows": {"vals_w": u[:4]},
        "op": {"op": "between"},
        "key": {"key": 2**31},
        "kind": {"kind": "b"},
        "valid": {"valid": torch.zeros((3, LANES), dtype=torch.int32)},
    }[bad])
    with pytest.raises(ValueError):
        run_filter.run_filter(**args)


def test_run_filter_is_a_registered_wrapper():
    """The launch counters the benchmark reads (kernels.WRAPPERS) hold K19."""
    assert kernels.WRAPPERS["run_filter"] is run_filter and "run_filter" in kernels.launches()
    run_filter.LAUNCHES = 5
    kernels.reset_launches()
    assert run_filter.LAUNCHES == 0
