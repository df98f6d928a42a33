"""giddy_tpu_torch's rle and rpe against giddy_tpu's, on the CPU: encode,
the host prep into the tile form (K5) or the scatter form (scatter-add +
K6), and decode through the kernels' plain versions against the JAX decode
(Pallas interpret mode) and the input. Everything is compared bit for bit
(tolerance 0)."""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu.kernels import rle as gt_rle
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import cumsum, rle
from giddy_tpu_torch.util import GROUP

from helpers import gen_column
from test_torch_host import assert_same_column, assert_same_streams
from test_torch_inputs import RUN_TABLE_CASES, run_tables

N = 2 * GROUP + 999  # three groups, the last one ragged
SCHEMES = ["rle", "rpe"]
# Run densities and the stream form each reaches: runs of 100-5000 (tile
# form, small w_pad), average run ~20 (16 < w_pad <= 128, the reference's
# _rank_call regime), average run 4 (scatter form), one run over the column.
DENSITIES = ["long", "mid", "dense", "single"]


def _runs(rng, n, avg):
    out = np.zeros(n, np.int32)
    pos = 0
    while pos < n:
        ln = int(rng.integers(1, 2 * avg))
        out[pos : pos + ln] = int(rng.integers(-5, 5))
        pos += ln
    return out


def values(density: str, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(density.encode()))
    if density == "long":
        return gen_column("rle", n, rng)
    if density == "single":
        return np.full(n, -7, np.int32)
    return _runs(rng, n, {"mid": 20, "dense": 4}[density])


@pytest.mark.parametrize("n", [N, GROUP])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_matches_reference(scheme, density, n):
    v = values(density, n)
    port = gtt.encode(v, scheme, name="c")
    assert_same_column(port, gt.encode(v, scheme, name="c"))
    assert gtt.decode_ref(port).tobytes() == v.tobytes()


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "uint32", "float32", "empty"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_and_oracle_dtypes_match_reference(scheme, dtype):
    rng = np.random.default_rng(51)
    raw = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)[rng.integers(0, 300, GROUP + 77) // 7]
    if dtype == "empty":
        v = np.zeros(0, np.int16)
    else:
        v = raw.view(np.float32) if dtype == "float32" else raw.astype(np.dtype(dtype))
    port, ref = gtt.encode(v, scheme), gt.encode(v, scheme)
    assert_same_column(port, ref)
    out = gtt.decode_ref(port)
    assert out.dtype == v.dtype
    assert out.tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_prep_matches_reference(scheme, density):
    """tile_prep, scatter_prep and the prep's choice between them, against
    giddy_tpu.kernels.rle at its default constants."""
    positions = scheme == "rpe"
    ref = gt.encode(values(density), scheme)
    col = gtt.from_reference(ref)
    r_pad, ng = col.params["r_pad"], 3
    bounds = col.streams["run_starts" if positions else "run_ends"].reshape(ng, r_pad)
    vals = col.streams["run_values"].reshape(ng, r_pad)
    tiles = rle.tile_prep(vals, bounds, positions=positions)
    want = gt_rle.tile_prep(vals, bounds, positions=positions)
    assert (tiles is None) == (want is None)
    if tiles is not None:
        assert_same_streams(tiles, want)
    assert_same_streams(rle.scatter_prep(vals, bounds, positions=positions),
                        gt_rle.scatter_prep(vals, bounds, positions=positions))
    got = rle.prep(col, positions=positions)
    assert_same_streams(got, gt_rle._prep(ref, positions=positions))
    if density == "dense":
        assert "pos" in got
    else:
        w_pad = got["vals_w"].shape[-1]
        assert {"long": w_pad <= rle.RANK_MIN, "mid": rle.RANK_MIN < w_pad <= rle.CHAIN_HARD,
                "single": got["vals_w"].shape[1] == 1}[density]
    assert rle.prep(dataclasses.replace(col, streams=got), positions=positions) is got  # passes through


def _decode_both(ref, **kw):
    out = gtt.decode(gtt.from_reference(ref), device="cpu", **kw)
    return out, np.asarray(gt.decode(ref, **kw))


@pytest.mark.parametrize("dtype", ["int32", "uint8", "int16"])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_matches_jax_and_input(scheme, density, dtype):
    v = values(density).astype(np.dtype(dtype))
    out, want = _decode_both(gt.encode(v, scheme))
    assert out.dtype == getattr(torch, dtype) and out.shape == (N,)
    assert out.numpy().tobytes() == want.tobytes() == v.tobytes()


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_pad_matches_jax(scheme, density):
    out, want = _decode_both(gt.encode(values(density), scheme), pad=True)
    assert out.shape == (3 * GROUP,)
    assert out.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("density", ["long", "single"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scatter_form_of_long_runs(scheme, density):
    """A column handed over already in scatter form (as dist and partial
    decode do) decodes through scatter-add + K6's plain version, where the
    prep alone would pick the tile form. The last group's pad sentinels
    point past the end and are dropped."""
    v = values(density)
    ref = gt.encode(v, scheme)
    col = gtt.from_reference(ref)
    r_pad, positions = col.params["r_pad"], scheme == "rpe"
    bounds = col.streams["run_starts" if positions else "run_ends"].reshape(3, r_pad)
    streams = gt_rle.scatter_prep(col.streams["run_values"].reshape(3, r_pad), bounds, positions=positions)
    assert (streams["pos"] == 3 * GROUP).any()
    ref_s = dataclasses.replace(ref, streams=streams)
    out, want = _decode_both(ref_s, pad=True)
    assert out.numpy().tobytes() == want.tobytes()
    assert out.numpy()[:N].tobytes() == v.tobytes()
    col_s = gtt.from_reference(ref_s)
    name, _ = kernels.kernel_call(col_s, gtt.device_streams(col_s, "cpu"), torch.int32)
    assert name == "cumsum_rows"


@pytest.mark.parametrize("density,name", [("long", "run_expand"), ("dense", "cumsum_rows")])
def test_kernel_call_names_the_form_and_cpu_launches_nothing(density, name):
    col = gtt.encode(values(density).astype(np.int16), "rle")
    store = gtt.narrow_store_dtype(col)
    assert store == torch.int16
    got, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), store)
    assert got == name
    before = kernels.launches()
    out = getattr(kernels.WRAPPERS[name], name)(*args)
    assert kernels.launches() == before
    assert out.dtype == torch.int16 and out.shape == (3, GROUP)
    assert out.reshape(-1)[:N].numpy().tobytes() == values(density).astype(np.int16).tobytes()


def test_scatter_dense_drops_out_of_range_pairs():
    pos = torch.tensor([[0, 5, GROUP], [GROUP + 3, 2 * GROUP, -1]], dtype=torch.int32)
    dv = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    dense = rle.scatter_dense(pos, dv, 2)
    assert dense.shape == (2, GROUP) and dense.is_contiguous()
    want = torch.zeros(2 * GROUP, dtype=torch.int32)
    want[[0, 5, GROUP, GROUP + 3]] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    assert torch.equal(dense.reshape(-1), want)
    assert cumsum.cumsum_rows(dense)[1, -1].item() == 7


def _tables(rows=4, w_pad=8, dtype=torch.int32):
    return torch.zeros((rows, w_pad), dtype=dtype), torch.zeros((rows, w_pad), dtype=dtype)


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: rle.run_expand(*_tables(), 3), ValueError),  # rows not a multiple of ng
        (lambda: rle.run_expand(*_tables(rows=3), 1), ValueError),  # T = 3
        (lambda: rle.run_expand(*_tables(rows=128), 1), ValueError),  # T = 128 > 64 (W = 256)
        (lambda: rle.run_expand(*_tables(w_pad=256), 1), ValueError),  # w_pad > CHAIN_HARD
        (lambda: rle.run_expand(*_tables(w_pad=12), 1), ValueError),  # w_pad not a power of two
        (lambda: rle.run_expand(_tables()[0], _tables(rows=2)[1], 1), ValueError),
        (lambda: rle.run_expand(*_tables(dtype=torch.int64), 1), TypeError),
        (lambda: rle.run_expand(*_tables(), 1, torch.int64), TypeError),
        (lambda: cumsum.cumsum_rows(torch.zeros((2, GROUP - 1), dtype=torch.int32)), ValueError),
        (lambda: cumsum.cumsum_rows(torch.zeros((2, GROUP), dtype=torch.int64)), TypeError),
    ],
)
def test_wrappers_reject_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()


def test_run_expand_plain_version():
    """Hand-made tables: two groups of two tiles (W = GROUP/2), one with a
    clipped sentinel end, one whose last entry is never selected."""
    ends = torch.tensor([[3, 16384, 16384, 16384], [0, 5, 16384, 16384],
                         [10, 20, 30, 40], [16384, 16384, 16384, 16384]], dtype=torch.int32)
    vals = torch.arange(16, dtype=torch.int32).reshape(4, 4) * 10
    out = rle.run_expand(ends, vals, 2).reshape(4, GROUP // 2)
    assert out[0, :3].tolist() == [0, 0, 0] and out[0, 3:].unique().tolist() == [10]
    assert out[1, :5].unique().tolist() == [50] and out[1, 5:].unique().tolist() == [60]
    assert out[2, [9, 10, 29, 30, 39, 40, 16383]].tolist() == [80, 90, 100, 110, 110, 110, 110]
    assert out[3].unique().tolist() == [120]


def _runs_of(avg: int, n: int = N) -> np.ndarray:
    """Runs of 1 .. 2 * avg - 1 positions over 18 values (neighbours may
    merge), seed avg."""
    rng = np.random.default_rng(avg)
    lengths = rng.integers(1, 2 * avg, 2 * (n // avg) + 16)
    return np.repeat(rng.integers(-9, 9, lengths.shape[0]).astype(np.int32), lengths)[:n]


def _burst(runs: int, long: int, n: int = N) -> np.ndarray:
    """Runs of ``long`` with one burst of ``runs`` runs of 3 at 40000."""
    v = np.repeat(np.arange(n // long + 1, dtype=np.int32) % 7, long)[:n].copy()
    v[40000 : 40000 + 3 * runs] = np.repeat(np.arange(runs, dtype=np.int32) + 100, 3)
    return v


# The tile-width chooser's regimes: input -> the (T, w_pad) it picks.
REGIMES = {
    "chain w_pad 8, T 1": (lambda: _runs_of(16000), (1, 8)),
    "chain w_pad 8, T 8": (lambda: _runs_of(1000), (8, 8)),
    "chain w_pad 8, T 64": (lambda: _runs_of(200), (64, 8)),
    "chain w_pad 16, T 32": (lambda: _runs_of(100), (32, 16)),
    "rank w_pad 32, T 1": (lambda: _burst(20, 5000), (1, 32)),
    "rank w_pad 64, T 1": (lambda: _burst(30, 5000), (1, 64)),
    "rank w_pad 128, T 8": (lambda: _runs_of(40), (8, 128)),
    "rank w_pad 128, T 32": (lambda: _runs_of(10), (32, 128)),
    "rank w_pad 128, T 64": (lambda: _runs_of(6), (64, 128)),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_tile_prep_meets_the_kernels_preconditions(regime):
    """What K5 relies on in the host prep's tables (both of its kernels
    select run #{m < w_pad - 1 : ends[m] <= j}; the rank form marks ends
    in a strip and scans it, so it needs them sorted), in each regime of
    the tile-width chooser: ends non-decreasing along each tile's row, at
    most w_pad - 1 of them below the tile width W, every entry after those
    equal to W, and K5's form as the reference splits _chain_call and
    _rank_call."""
    make, (tiles, w_pad) = REGIMES[regime]
    v = make()
    for scheme in SCHEMES:
        streams = rle.prep(gtt.encode(v, scheme), positions=scheme == "rpe")
        assert streams["ends_w"].shape == (3, tiles, w_pad)
        ends = streams["ends_w"].reshape(-1, w_pad).astype(np.int64)
        width = GROUP // tiles
        assert (np.diff(ends, axis=1) >= 0).all() and (ends >= 0).all()
        below = (ends < width).sum(axis=1)
        assert below.max() <= w_pad - 1
        assert (ends[np.arange(w_pad)[None, :] >= below[:, None]] == width).all()
        assert rle.form(w_pad) == ("rank" if regime.startswith("rank") else "chain")


def test_form_launches_stay_zero_on_the_cpu():
    """K5's per-form counts (and its count) move only where a kernel
    launches: never for tables on the CPU, of either form."""
    kernels.reset_launches()
    for w_pad in (8, 16, 32, 128):
        ends, vals = run_tables("random", w_pad, 32, 2)
        rle.run_expand(torch.from_numpy(ends), torch.from_numpy(vals), 2)
    for density in ("long", "mid"):
        gtt.decode(gtt.encode(values(density), "rle"), device="cpu")
    assert kernels.form_launches() == {"chain": 0, "rank": 0}
    assert kernels.launches()["run_expand"] == 0


@pytest.mark.parametrize("w_pad", [8, 32, 128])
@pytest.mark.parametrize("case", [c for c in RUN_TABLE_CASES if c != "outside"])
def test_run_tables_match_reference_calls(case, w_pad):
    """Hand-made tables in the prep's form through K5's plain version and
    the reference's own expansion (_chain_call at w_pad <= RANK_MIN,
    _rank_call above, interpret mode): 64 tiles of W = 512, bit for bit."""
    import jax.numpy as jnp

    ends, vals = run_tables(case, w_pad, 64, 1, seed=w_pad)
    got = rle.run_expand(torch.from_numpy(ends), torch.from_numpy(vals), 1).reshape(64, 512)
    call = gt_rle._rank_call if w_pad > rle.RANK_MIN else gt_rle._chain_call
    want = np.asarray(call(64, 512, w_pad)(jnp.asarray(ends), jnp.asarray(vals.view(np.uint32))))
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
