"""giddy_tpu_torch's CUDA kernels against their plain PyTorch versions and
the NumPy oracle, on the card. Every test here needs a CUDA device and
skips without one. The file imports no JAX, so it runs on a GPU machine
that has none:

    python -m pytest tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import aggregate, kernels, nulls, query
from giddy_tpu_torch.datagen import CORE_SCHEMES
from giddy_tpu_torch.groupby import _codes_device_column
from giddy_tpu_torch.kernels import (
    _wrap, agg, cascade, delta2, dict_, dzbv, encode, filter_, lanes, nbit, patch, rle, run_filter,
)
from giddy_tpu_torch.ref import lmp as ref_lmp
from giddy_tpu_torch.util import GROUP, LANES, np_dtype, pad_to_groups

from test_torch_inputs import (
    DICT_KINDS, OPS, PRIORITIES, RUN_TABLE_CASES, SCAN_DTYPES, STRING_KINDS, WIDE_KINDS, WINDOW_HEAD, assert_same_column,
    bitmap_values, dict_values, dzbv_values, for_values, rng_of, run_table_values, run_tables, salted_prices, scan_runs,
    scan_thresholds, scan_values, string_values, want_agg, want_mask, wide_thresholds, wide_values, wrapping_walk,
)

pytestmark = pytest.mark.cuda

N = 3 * GROUP + 17


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _values(scheme, dtype, rng):
    if scheme in ("delta", "delta2", "xordelta"):
        v = (np.cumsum(rng.integers(-(2**20), 2**20, N)) + 1_600_000_000).astype(np.int64)
    elif scheme == "dict":
        v = rng.integers(-(2**31), 2**31, 300, dtype=np.int64)[rng.integers(0, 300, N)]
    elif scheme in ("rle", "rpe"):  # runs of ~50 (tile form)
        v = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.int64)[rng.integers(0, 300, N // 50 + 1)]
        v = np.repeat(v, 50)[:N]
    else:
        v = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.int64)
    u = v.astype(np.uint32)  # wraps: every dtype sees its full bit range
    return u.view(np.dtype(dtype)) if dtype in ("int32", "float32") else u.astype(np.dtype(dtype))


def _run_values(density, rng, n=N):
    """Runs of 100-5000 (tile form, small w_pad), of ~20 (16 < w_pad <=
    128), of ~4 (scatter form), or one run over the column."""
    if density == "single":
        return np.full(n, -7, np.int32)
    lo, hi = {"long": (100, 5000), "mid": (1, 40), "dense": (1, 8)}[density]
    lengths = rng.integers(lo, hi, n // lo + 1)
    return np.repeat(rng.integers(-(2**31), 2**31, lengths.shape[0], dtype=np.int64), lengths)[:n].astype(np.int32)


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32", "int16", "uint16", "int8", "uint8"])
@pytest.mark.parametrize("scheme", ["nbit", "dzbf", "for", "delta", "dict", "rle", "rpe", "delta2", "xordelta"])
def test_kernel_matches_plain_and_oracle(cuda, scheme, dtype):
    v = _values(scheme, dtype, np.random.default_rng(5))
    col = gtt.encode(v, scheme)
    store = gtt.narrow_store_dtype(col)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), store)
    before = kernels.launches()[name]
    got = getattr(kernels.WRAPPERS[name], name)(*args)
    assert kernels.launches()[name] == before + 1
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == store and torch.equal(got, want)
    out = gtt.decode(col, device=cuda)
    assert out.is_cuda and out.shape == (N,)
    signed = {4: torch.int32, 2: torch.int16, 1: torch.int8}[v.itemsize]
    assert out.view(signed).cpu().numpy().tobytes() == gtt.decode_ref(col).tobytes() == v.tobytes()


@pytest.mark.parametrize("d", [1, 2049, 65536])
def test_dict_shared_and_global_modes(cuda, d):
    rng = np.random.default_rng(d)
    vocab = rng.permutation(np.arange(d, dtype=np.int64) * 65_537 - 2**31 + 7).astype(np.int32)
    v = vocab[rng.integers(0, d, N)]
    col = gtt.encode(v, "dict", dictionary=vocab)
    assert dict_.dict_in_shared(d) == (d <= 2049)  # 256 KiB exceeds any block's shared memory
    np.testing.assert_array_equal(gtt.decode(col, device=cuda).cpu().numpy(), v)


@pytest.mark.parametrize("density", ["long", "mid", "dense", "single"])
@pytest.mark.parametrize("scheme", ["rle", "rpe"])
def test_run_expansion_forms(cuda, scheme, density):
    v = _run_values(density, np.random.default_rng(6))
    col = gtt.encode(v, scheme)
    streams = gtt.device_streams(col, cuda)
    assert ("pos" in streams) == (density == "dense")
    name, args = kernels.kernel_call(col, streams, torch.int32)
    assert name == ("cumsum_rows" if density == "dense" else "run_expand")
    got = getattr(kernels.WRAPPERS[name], name)(*args)
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(gtt.decode(col, device=cuda).cpu().numpy(), v)


RUN_PADS = [8, 16, 32, 64, 128]  # the chain form's w_pad, then the rank form's


def _expand_both(cuda, ends, vals, ng, store, lut=None):
    """K5 and its plain version on the same tables on the card."""
    e, v = torch.from_numpy(ends).to(cuda), torch.from_numpy(vals).to(cuda)
    got = rle.run_expand(e, v, ng, store, lut)
    want = lanes.run_expand(e, v, ng, store, lut)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("tiles", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("w_pad", RUN_PADS)
def test_run_expand_at_every_form_and_tile_count(cuda, w_pad, tiles):
    """K5 against its plain version, bit for bit, at every w_pad of both
    forms and every tile count T (W from 32768 down to 512), at each store
    width, with and without a cascade table (codes past its end clamp);
    each launch counted once, in its form."""
    ends, vals = run_tables("random", w_pad, tiles, 3, seed=w_pad * tiles)
    codes = (vals.view(np.uint32) % 1200).astype(np.int32)
    lut = torch.from_numpy(rng_of("k5 table").integers(-(2**31), 2**31, 1000, dtype=np.int64).astype(np.int32))
    form = "rank" if w_pad > rle.RANK_MIN else "chain"
    for store in (torch.int32, torch.int16, torch.uint8):
        for table, v in ((None, vals), (lut.to(cuda), codes)):
            before = kernels.form_launches()
            got, want = _expand_both(cuda, ends, v, 3, store, table)
            assert got.dtype == want.dtype == store and torch.equal(got, want), (store, table is None)
            after = kernels.form_launches()
            assert after[form] == before[form] + 1 and sum(after.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("case", RUN_TABLE_CASES)
@pytest.mark.parametrize("w_pad", RUN_PADS)
def test_run_expand_edge_tables(cuda, w_pad, case):
    """K5 against its plain version, bit for bit, on hand-made tables
    (test_torch_inputs.run_tables): equal ends, ends of 0, all-pad tiles,
    runs of one (more than 32 ends in one 128-position step of a warp),
    ends across a warp's span edge, ends outside [0, W]; one group, and
    three with a padded last group; W of 32768, 1024 and 512; 4- and
    1-byte stores."""
    for tiles in (1, 32, 64):
        for ng in (1, 3):
            ends, vals = run_tables(case, w_pad, tiles, ng, seed=tiles + ng)
            for store in (torch.int32, torch.uint8):
                got, want = _expand_both(cuda, ends, vals, ng, store)
                assert torch.equal(got, want), (tiles, ng, store)


def test_run_expand_wants_aligned_tables(cuda):
    """K5 reads its tables with vector loads of 4 * max(1, w_pad / 32)
    bytes a lane: tables 4 bytes past such a boundary raise before any
    launch at w_pad 64 and 128, and are taken at w_pad <= 32."""
    for w_pad in (8, 32, 64, 128):
        ends, vals = run_tables("random", w_pad, 32, 1)
        flat = torch.zeros(ends.size + 1, dtype=torch.int32, device=cuda)
        flat[1:] = torch.from_numpy(ends.reshape(-1)).to(cuda)
        shifted = flat[1:].view(ends.shape)
        v = torch.from_numpy(vals).to(cuda)
        if w_pad <= 32:
            assert torch.equal(rle.run_expand(shifted, v, 1), lanes.run_expand(shifted, v, 1))
            continue
        before = kernels.form_launches()
        with pytest.raises(ValueError, match=f"{w_pad // 8}-byte aligned"):
            rle.run_expand(shifted, v, 1)
        assert kernels.form_launches() == before


@pytest.mark.parametrize("n", [N, GROUP, 0])
@pytest.mark.parametrize("exclusive", [False, True])
def test_group_prefix_sum(cuda, exclusive, n):
    x = torch.from_numpy(np.random.default_rng(n).integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32))
    before = kernels.launches()["cumsum_rows"]
    got = gtt.scan.group_prefix_sum(x.to(cuda), exclusive=exclusive)
    assert got.is_cuda and kernels.launches()["cumsum_rows"] == before + 1
    want = gtt.scan.group_prefix_sum(x, exclusive=exclusive)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_run_expand_rejects_bad_tables_on_cuda(cuda):
    tables = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no run-expand kernel"):
        rle.run_expand(tables, tables, 1)
    with pytest.raises(ValueError):
        rle.run_expand(tables, tables.cpu(), 3)


def test_kernel_rejects_tensors_on_two_devices(cuda):
    col = gtt.encode(np.arange(GROUP, dtype=np.int32), "dict")
    streams = gtt.device_streams(col, cuda)
    with pytest.raises(ValueError, match="values is on cpu"):
        dict_.dict_decode(streams["codes"], streams["values"].cpu(), col.params["bits"])
    with pytest.raises(TypeError):
        nbit.lmp_unpack(streams["codes"].to(torch.int64), col.params["bits"])


def _patched_values(dtype, rng, n=N):
    """Mostly small values and ~1% wide exceptions, with exceptions at 0,
    n-1 and on both sides of every group boundary."""
    v = rng.integers(0, 16, n, dtype=np.int64)
    idx = np.concatenate([rng.choice(n, max(1, n // 100), replace=False), [0, n - 1],
                          [p for g in range(1, n // GROUP + 1) for p in (g * GROUP - 1, g * GROUP) if p < n]])
    v[idx] = rng.integers(2**20, 2**31, idx.shape[0])
    u = v.astype(np.uint32)
    return u.view(np.dtype(dtype)) if dtype in ("int32", "float32") else u.astype(np.dtype(dtype))


@pytest.mark.parametrize("dtype", ["int32", "float32", "int16", "uint8"])
@pytest.mark.parametrize("kind", ["naive", "compressed"])
@pytest.mark.parametrize("base", ["for", "nbit"])
def test_patched_kernel_matches_plain_and_oracle(cuda, base, kind, dtype):
    v = _patched_values(dtype, np.random.default_rng(7))
    col = gtt.encode(v, "patched", base_scheme=base, kind=kind, frame_len=2 * GROUP)
    assert col.params["count"] > 0
    store = gtt.narrow_store_dtype(col)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), store)
    assert name == "patched_decode"
    before = kernels.launches()["patched_decode"]
    got = patch.patched_decode(*args)
    assert kernels.launches()["patched_decode"] == before + 1
    want = lanes.patched_decode(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == store and torch.equal(got, want)
    signed = {4: torch.int32, 2: torch.int16, 1: torch.int8}[v.itemsize]
    out = gtt.decode(col, device=cuda)
    assert out.view(signed).cpu().numpy().tobytes() == gtt.decode_ref(col).tobytes() == v.tobytes()


@pytest.mark.parametrize("n", [GROUP, 1, 0])
def test_patched_without_exceptions(cuda, n):
    v = np.arange(n, dtype=np.int32) % 100
    for kind in ("naive", "compressed"):
        col = gtt.encode(v, "patched", kind=kind)
        assert col.params["count"] == 0
        np.testing.assert_array_equal(gtt.decode(col, device=cuda).cpu().numpy(), v)
        name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
        assert torch.equal(patch.patched_decode(*args), lanes.patched_decode(*args))


def _cascade_values(d, rng, n=N, run=50):
    vocab = rng.permutation(np.arange(d, dtype=np.int64) * 65_537 - 2**31 + 3).astype(np.int32)
    codes = np.repeat(rng.integers(0, d, n // run + 1), run)[:n]
    return vocab[codes], vocab


@pytest.mark.parametrize("d", [1, 8, 2049, 65536])
@pytest.mark.parametrize("inner", ["rle", "rpe", "delta", "delta2", "nbit", "for", "dzbf", "raw"])
def test_cascade_lut_matches_plain_and_oracle(cuda, inner, d):
    v, vocab = _cascade_values(d, np.random.default_rng(d))
    col = gtt.encode(v, "cascade", codes_scheme=inner, dictionary=vocab)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    before = kernels.launches()
    got = cascade.cascade_lut(name, args)
    after = kernels.launches()
    assert after["cascade_lut"] == before["cascade_lut"] + 1 and after[name] == before[name] + 1
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(gtt.decode(col, device=cuda).cpu().numpy(), v)


@pytest.mark.parametrize("inner,run", [("delta", 50), ("delta2", 50), ("rle", 1)])
def test_cascade_lut_table_just_under_48_kb(cuda, inner, run):
    """A table of d = 12250 (49,000 B, just under the default 48 KB of
    dynamic shared memory) in shared memory beside the static warp totals
    of K3, K7 and K6 (rle in the scatter form): the sum passes 48 KB, so
    the launch needs the opt-in all the same."""
    d = 12250
    v, vocab = _cascade_values(d, np.random.default_rng(d), run=run)
    col = gtt.encode(v, "cascade", codes_scheme=inner, dictionary=vocab)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    got = cascade.cascade_lut(name, args)
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(gtt.decode(col, device=cuda).cpu().numpy(), v)


@pytest.mark.parametrize("d", [1, 8, 1000, 12250, "limit - 1", "limit", "limit + 1"])
def test_cascade_delta2_table_modes(cuda, d):
    """K7 with cascade's table beside its 66 KB of buffers: in shared memory
    up to the limit (36,864 entries on an H100), from global memory above
    it; the kernel equals its plain version and decodes the input."""
    limit = delta2.shared_lut_limit()
    assert 16_000 < limit < 48_000
    if isinstance(d, str):
        d = limit + {"limit - 1": -1, "limit": 0, "limit + 1": 1}[d]
    assert delta2.lut_in_shared(d) == (d <= limit)
    v, vocab = _cascade_values(d, np.random.default_rng(d))
    col = gtt.encode(v, "cascade", codes_scheme="delta2", dictionary=vocab)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    assert name == "delta2_decode"
    before = kernels.launches()
    got = cascade.cascade_lut(name, args)
    assert kernels.launches()["delta2_decode"] == before["delta2_decode"] + 1
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(gtt.decode(col, device=cuda).cpu().numpy(), v)


@pytest.mark.parametrize("groups", ["one", "past the grid"])
@pytest.mark.parametrize("bits", range(1, 33))
def test_delta2_decode_at_every_width(cuda, bits, groups):
    """K7 on random second differences at every width B, with anchors and
    slopes across the int32 range (every sum wraps mod 2^32), at every store
    width, against the plain version bit for bit; on one group and on 2 *
    SMs + 3 (two blocks an SM, and then some)."""
    rng = rng_of(f"delta2/{bits}/{groups}")
    ng = _staged_groups(groups, cuda)
    packed = _words(rng, (ng, bits * LANES), cuda)
    anchors = _words(rng, (ng,), cuda)
    slopes = _words(rng, (ng,), cuda)
    slopes[0] = 2**31 - 1
    for store in (torch.int32, torch.int16, torch.uint8):
        before = kernels.launches()["delta2_decode"]
        got = delta2.delta2_decode(packed, anchors, slopes, bits, store)
        assert kernels.launches()["delta2_decode"] == before + 1
        want = lanes.delta2_decode(packed, anchors, slopes, bits, store)
        torch.cuda.synchronize()
        assert got.dtype == store and torch.equal(got, want), store


@pytest.mark.parametrize("n", [1, 1000, GROUP + 1, 3 * GROUP + 17])
def test_delta2_decode_wrapping_walk_ragged(cuda, n):
    """delta2 of a walk that crosses the int32 wrap, n not a multiple of
    GROUP: the kernel equals its plain version over all n_pad values and
    decodes the input."""
    v = wrapping_walk(n, rng_of(f"delta2-walk/{n}"))
    col = gtt.encode(v, "delta2")
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    got = getattr(kernels.WRAPPERS[name], name)(*args)
    assert torch.equal(got, getattr(lanes, name)(*args))
    assert got.reshape(-1)[:n].cpu().numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize("dtype", ["int16", "uint8", "float32"])
@pytest.mark.parametrize("run", [1, 50])  # 1: rle/rpe in the scatter form (K6 with the table)
@pytest.mark.parametrize("inner", ["rle", "rpe", "delta", "delta2", "for"])
def test_cascade_lut_forms_and_narrow_stores(cuda, inner, run, dtype):
    rng = np.random.default_rng(run)
    u = _cascade_values(300, rng, run=run)[0].view(np.uint32)
    v = u.view(np.float32) if dtype == "float32" else u.astype(np.dtype(dtype))
    col = gtt.encode(v, "cascade", codes_scheme=inner)
    streams = gtt.device_streams(col, cuda)
    if inner in ("rle", "rpe"):
        assert ("c_pos" in streams) == (run == 1)
    name, args = kernels.kernel_call(col, streams, gtt.narrow_store_dtype(col))
    got = cascade.cascade_lut(name, args)
    assert torch.equal(got, getattr(lanes, name)(*args))
    signed = {4: torch.int32, 2: torch.int16, 1: torch.int8}[v.itemsize]
    out = gtt.decode(col, device=cuda)
    assert out.view(signed).cpu().numpy().tobytes() == v.tobytes()


def test_decode_columns_without_host_sync(cuda):
    rng = np.random.default_rng(0)
    cols, values = [], {}
    for s in ("delta", "dict", "rle", "patched", "cascade", "raw"):
        values[f"mix_{s}"] = v = gtt.datagen.gen_column(s, N, rng)
        cols.append(gtt.encode(v, s, name=f"mix_{s}"))
    outs = gtt.decode_columns(cols, device=cuda)
    assert sorted(outs) == sorted(values)
    for name, v in values.items():
        np.testing.assert_array_equal(outs[name].cpu().numpy(), v)
    streams = [gtt.device_streams(c, cuda) for c in cols]
    decoders = [gtt.get_decoder(c, gtt.narrow_store_dtype(c)) for c in cols]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        resident = [dec(s) for dec, s in zip(decoders, streams)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for c, u in zip(cols, resident):
        np.testing.assert_array_equal(u[: c.n].cpu().numpy(), values[c.name])


def _check_epilogue(col, v, cuda):
    """K10/K11/K12 through kernel_call: the wrapper launches once and equals
    its plain version on the card; decode equals the oracle and the input."""
    store = gtt.narrow_store_dtype(col)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), store)
    assert name == {"model": "model_decode", "bitmap": "bitmap_decode", "alp": "alp_decode"}[col.scheme]
    before = kernels.launches()[name]
    got = getattr(kernels.WRAPPERS[name], name)(*args)
    assert kernels.launches()[name] == before + 1
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == store and torch.equal(got, want)
    signed = {4: torch.int32, 2: torch.int16, 1: torch.int8}[v.itemsize]
    out = gtt.decode(col, device=cuda)
    assert out.is_cuda and out.shape == v.shape
    assert out.view(signed).cpu().numpy().tobytes() == gtt.decode_ref(col).tobytes() == v.tobytes()


@pytest.mark.parametrize("frame_len", [GROUP, 4 * GROUP])
@pytest.mark.parametrize("kind", ["auto", "linear", "poly2"])
def test_model_kernel_matches_plain_and_oracle(cuda, kind, frame_len):
    v = gtt.datagen.gen_column("model", N, np.random.default_rng(frame_len), frame_len=frame_len)
    _check_epilogue(gtt.encode(v, "model", kind=kind, frame_len=frame_len), v, cuda)


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint16", "uint32"])
def test_model_kernel_stores(cuda, dtype):
    v = gtt.datagen.gen_column("model", N, np.random.default_rng(11))
    v = v.view(np.uint32) if dtype == "uint32" else v.astype(np.dtype(dtype))
    _check_epilogue(gtt.encode(v, "model"), v, cuda)


def test_model_kernel_32_bits_and_wrapping_coefficients(cuda):
    v = gtt.datagen.gen_column("model", N, np.random.default_rng(12), hard=True)
    _check_epilogue(gtt.encode(v, "model", bits=32), v, cuda)
    col = gtt.encode(v, "model", kind="poly2", frame_len=4 * GROUP)
    col.streams.update(coef_a=np.array([2**31 - 1], np.int32), coef_b=np.array([-(2**31)], np.int32),
                       coef_c=np.array([2**31 - 7], np.int32))
    _check_epilogue(col, gtt.decode_ref(col), cuda)


@pytest.mark.parametrize("d", [1, 4, 12, 64, 65, 1000])
def test_bitmap_kernel_every_d(cuda, d):
    v = bitmap_values(d, N if d < 1000 else 4 * GROUP + 999, np.random.default_rng(d))
    col = gtt.encode(v, "bitmap")
    assert col.params["d"] == d
    _check_epilogue(col, v, cuda)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16"])
def test_bitmap_kernel_narrow_stores(cuda, dtype):
    v = bitmap_values(12, N, np.random.default_rng(13), dtype)
    _check_epilogue(gtt.encode(v, "bitmap"), v, cuda)


def test_bitmap_kernel_sums_two_incident_bits(cuda):
    v = bitmap_values(4, N, np.random.default_rng(14))
    col = gtt.encode(v, "bitmap")
    col.streams["bitmaps"] = col.streams["bitmaps"].copy()
    col.streams["bitmaps"][1] |= col.streams["bitmaps"][0]
    _check_epilogue(col, gtt.decode_ref(col), cuda)


def test_bitmap_empty_column_launches_nothing(cuda):
    col = gtt.encode(np.zeros(0, np.int32), "bitmap")
    before = kernels.launches()
    out = gtt.decode(col, device=cuda, pad=True)
    assert kernels.launches() == before and out.shape == (GROUP,) and not out.any()


def _alp_values(data, rng, n=N):
    if data == "salted":
        return salted_prices(n, rng)
    return gtt.datagen.gen_column("alp", n, rng, hard=data == "hard")


@pytest.mark.parametrize("e", [None, 0, 2, 10])
@pytest.mark.parametrize("data", ["prices", "hard", "salted"])
def test_alp_kernel_matches_plain_and_oracle(cuda, data, e):
    v = _alp_values(data, np.random.default_rng(15))
    col = gtt.encode(v, "alp", e=e)
    if data == "prices" and e is None:
        assert col.params["count"] == 0
    _check_epilogue(col, v, cuda)


@pytest.mark.parametrize("scheme", ["model", "alp"])
def test_epilogue_schemes_at_n_0(cuda, scheme):
    col = gtt.encode(np.zeros(0, np.float32 if scheme == "alp" else np.int32), scheme)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    got = getattr(kernels.WRAPPERS[name], name)(*args)
    assert torch.equal(got, getattr(lanes, name)(*args))
    assert gtt.decode(col, device=cuda).shape == (0,)


def test_epilogue_wrappers_reject_bad_arguments_on_cuda(cuda):
    from giddy_tpu_torch.kernels import alp, bitmap, model

    col = gtt.encode(_alp_values("salted", np.random.default_rng(16)), "alp")
    _, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    with pytest.raises(ValueError, match="refs_g is on cpu"):
        alp.alp_decode(args[0], args[1], args[2].cpu(), *args[3:])
    with pytest.raises(ValueError, match="pos is on cpu"):
        alp.alp_decode(*args[:3], args[3].cpu(), *args[4:])
    with pytest.raises(ValueError, match="corr is on cpu"):
        alp.alp_decode(args[0], args[1].cpu(), *args[2:])
    col = gtt.encode(bitmap_values(4, N, np.random.default_rng(17)), "bitmap")
    bitmaps, values, ng, _ = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)[1]
    with pytest.raises(ValueError, match="values is on cpu"):
        bitmap.bitmap_decode(bitmaps, values.cpu(), ng)
    col = gtt.encode(gtt.datagen.gen_column("model", N, np.random.default_rng(18)), "model", kind="poly2")
    packed, a_g, b_g, c_g, bits, _ = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)[1]
    with pytest.raises(ValueError, match="c_g is on cpu"):
        model.model_decode(packed, a_g, b_g, c_g.cpu(), bits)


def test_epilogue_columns_without_host_sync(cuda):
    rng = np.random.default_rng(19)
    cols, values = [], {}
    for s in ("model", "bitmap", "alp"):
        values[s] = v = gtt.datagen.gen_column(s, N, rng)
        cols.append(gtt.encode(v, s, name=s))
    cols[-1] = gtt.encode(_alp_values("salted", rng), "alp", name="alp")  # with exceptions
    values["alp"] = gtt.decode_ref(cols[-1])
    assert cols[-1].params["count"] > 0
    outs = gtt.decode_columns(cols, device=cuda)
    for name, v in values.items():
        assert outs[name].cpu().numpy().tobytes() == v.tobytes()
    streams = [gtt.device_streams(c, cuda) for c in cols]
    decoders = [gtt.get_decoder(c, gtt.narrow_store_dtype(c)) for c in cols]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        resident = [dec(s) for dec, s in zip(decoders, streams)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for c, u in zip(cols, resident):
        assert u[: c.n].cpu().numpy().tobytes() == values[c.name].view(np.int32).tobytes()


DZBV_FORMS = {"tile": "dzbv_tile_decode", "group": "dzbv_group_decode", "plane": "dzbv_plane_decode"}


def _check_dzbv(col, streams: dict, v: np.ndarray, cuda) -> str:
    """K13/K14/K15 on the streams of one form: the wrapper launches once and
    equals its plain version on the card, and the output the oracle and the
    input; returns the kernel's name."""
    store = gtt.narrow_store_dtype(col)
    name, args = kernels.kernel_call(col, gtt.upload(streams, cuda), store)
    before = kernels.launches()[name]
    got = getattr(kernels.WRAPPERS[name], name)(*args)
    assert kernels.launches()[name] == before + 1
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == store and torch.equal(got, want)
    out = got.reshape(-1)[: v.shape[0]].cpu().numpy()
    assert out.tobytes() == gtt.decode_ref(col).tobytes() == v.tobytes()
    return name


@pytest.mark.parametrize("n", [100, GROUP, N])
@pytest.mark.parametrize("form", list(DZBV_FORMS))
def test_dzbv_forms_match_plain_and_oracle(cuda, form, n):
    v = dzbv_values("mixed", n, rng_of(f"mixed{n}")).view(np.int32)
    col = gtt.encode(v, "dzbv")
    assert _check_dzbv(col, dzbv.form_streams(col, form), v, cuda) == DZBV_FORMS[form]


@pytest.mark.parametrize("per_tile,strides", [
    (5, (8, 8, 8)), (5, (24, 40, 120)), (16, (16, 24, 40)), (16, (32, 64, 128)),
    (50, (56, 88, 104)), (100, (104, 120, 128)), (128, (128, 128, 128)),
])
def test_dzbv_forced_tile_strides(cuda, per_tile, strides):
    v = dzbv_values("per_tile", 2 * GROUP + 5, rng_of(f"tile{per_tile}"), per_tile=per_tile).view(np.int32)
    col = gtt.encode(v, "dzbv")
    _check_dzbv(col, dzbv.tile_prep(col, force_s=dict(zip((1, 2, 3), strides))), v, cuda)


@pytest.mark.parametrize("kind", ["skewed", "group_skewed", "one_byte", "two_bytes", "full"])
@pytest.mark.parametrize("form", list(DZBV_FORMS))
def test_dzbv_skew_and_plane_counts(cuda, form, kind):
    v = dzbv_values(kind, N, rng_of(kind)).view(np.int32)
    col = gtt.encode(v, "dzbv")
    _check_dzbv(col, dzbv.form_streams(col, form), v, cuda)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "float32"])
@pytest.mark.parametrize("form", list(DZBV_FORMS))
def test_dzbv_narrow_stores(cuda, form, dtype):
    u = dzbv_values("mixed", N, rng_of(dtype))
    v = u.view(np.float32) if dtype == "float32" else u.astype(np.dtype(dtype))
    col = gtt.encode(v, "dzbv")
    _check_dzbv(col, dzbv.form_streams(col, form), v, cuda)


@pytest.mark.parametrize("kind,form", [("mixed", "tile"), ("skewed", "group"), ("group_skewed", "plane")])
def test_dzbv_decode_takes_the_prep_form(cuda, kind, form):
    v = dzbv_values(kind, 8 * GROUP if kind == "mixed" else N, rng_of(kind)).view(np.int32)
    col = gtt.encode(v, "dzbv")
    before = kernels.launches()[DZBV_FORMS[form]]
    out = gtt.decode(col, device=cuda)
    assert kernels.launches()[DZBV_FORMS[form]] == before + 1
    assert out.is_cuda and out.cpu().numpy().tobytes() == v.tobytes()
    assert gtt.decode(gtt.encode(v[:0], "dzbv"), device=cuda).shape == (0,)


def test_dzbv_wrappers_reject_streams_on_two_devices(cuda):
    col = gtt.encode(dzbv_values("mixed", N, rng_of("devices")), "dzbv")
    for form in DZBV_FORMS:
        up = gtt.upload(dzbv.form_streams(col, form), cuda)
        name, (widths, plane0, planes, store) = kernels.kernel_call(col, up, torch.int32)
        with pytest.raises(ValueError):
            getattr(dzbv, name)(widths, plane0, (planes[0].cpu(), *planes[1:]), store)
        with pytest.raises(ValueError):
            getattr(dzbv, name)(widths, plane0.cpu(), planes, store)


@functools.cache
def _dzbv_column(wide_bytes: int, per_tile: int, ng: int) -> tuple:
    """(values, column) of ng groups with exactly per_tile values wide_bytes
    wide in every 128-value tile (planes 1 .. wide_bytes - 1), the rest one
    byte wide; kept for the cases that share it."""
    v = dzbv_values("per_tile", ng * GROUP, rng_of(f"staged/{wide_bytes}/{per_tile}/{ng}"), per_tile=per_tile,
                    wide_bytes=wide_bytes).view(np.int32)
    return v, gtt.encode(v, "dzbv")


def _check_staged(name: str, col, streams: dict, v: np.ndarray, cuda) -> None:
    """The staged kernel ``name`` (K13 or K14) launches once on the streams
    and equals its plain version on the card and the input, bit for bit."""
    got_name, args = kernels.kernel_call(col, gtt.upload(streams, cuda), torch.int32)
    assert got_name == name
    before = kernels.launches()[name]
    got = getattr(dzbv, name)(*args)
    assert kernels.launches()[name] == before + 1
    want = getattr(lanes, name)(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.reshape(-1).cpu().numpy().tobytes() == v.tobytes()


def _staged_groups(groups: str, cuda) -> int:
    return 1 if groups == "one" else 2 * torch.cuda.get_device_properties(cuda).multi_processor_count + 3


@pytest.mark.parametrize("groups", ["one", "past the grid"])
@pytest.mark.parametrize("planes", [1, 2, 3])
@pytest.mark.parametrize("s", range(8, 129, 8))
def test_dzbv_tile_decode_at_every_stride(cuda, s, planes, groups):
    """K13 at stride s with planes 1..planes, through tile_prep(force_s):
    one group with exactly s of the widest values in every tile (each tile's
    row slot full), and 2 * SMs + 3 groups (two blocks an SM, and then some)
    with 8 in every tile."""
    ng = _staged_groups(groups, cuda)
    v, col = _dzbv_column(planes + 1, s if ng == 1 else 8, ng)
    streams = dzbv.tile_prep(col, force_s=dict.fromkeys(range(1, planes + 1), s))
    _check_staged("dzbv_tile_decode", col, streams, v, cuda)


@pytest.mark.parametrize("groups", ["one", "past the grid"])
@pytest.mark.parametrize("planes", [1, 2, 3])
@pytest.mark.parametrize("w4", range(1, 9))
def test_dzbv_group_decode_at_every_row_width(cuda, w4, planes, groups):
    """K14 at row width w4 with planes 1..planes, through
    group_prep(force_w4): one group with exactly 16 * w4 of the widest
    values in every tile (its rows full, 4096 * w4 bytes), and 2 * SMs + 3
    groups with 16 in every tile."""
    ng = _staged_groups(groups, cuda)
    v, col = _dzbv_column(planes + 1, 16 * w4 if ng == 1 else 16, ng)
    streams = dzbv.group_prep(col, force_w4=dict.fromkeys(range(1, planes + 1), w4))
    _check_staged("dzbv_group_decode", col, streams, v, cuda)


@pytest.mark.parametrize("form", ["tile", "group"])
def test_dzbv_staged_kernels_on_random_streams(cuda, form):
    """K13 and K14 on random width codes, plane 0 and rows, so that tiles
    and groups hold more values than their rows (K13 clamps into its row,
    K14 reads 0 past it), at every store width and with plane 2 absent,
    against the plain versions bit for bit."""
    rng = rng_of(f"staged-random/{form}")
    ng = 5
    name = f"dzbv_{form}_decode"
    unit, shapes = (64, (8, 64, 128)) if form == "tile" else (LANES, (1, 4, 8))
    widths, plane0 = _words(rng, (ng, 2 * LANES), cuda), _words(rng, (ng, 8 * LANES), cuda)
    rows = tuple(_words(rng, (ng, unit * a), cuda) for a in shapes)
    for planes in (rows, (rows[0], None, rows[2])):
        for store in (torch.int32, torch.int16, torch.uint8):
            got = getattr(dzbv, name)(widths, plane0, planes, store)
            want = getattr(lanes, name)(widths, plane0, planes, store)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (planes[1] is None, store)


def test_dzbv_wrappers_reject_misaligned_rows(cuda):
    """K13, K14 and K15 stage each group's plane rows with bulk copies, which
    need 16-byte aligned streams: a view 4 bytes off raises and nothing
    launches; the aligned view launches."""
    ng = 2
    widths = torch.zeros((ng, 2 * LANES), dtype=torch.int32, device=cuda)
    plane0 = torch.zeros((ng, 8 * LANES), dtype=torch.int32, device=cuda)
    for name, words in (("dzbv_tile_decode", 64 * 8), ("dzbv_group_decode", LANES), ("dzbv_plane_decode", 8 * LANES)):
        flat = torch.zeros(ng * words + 1, dtype=torch.int32, device=cuda)
        before = kernels.launches()
        with pytest.raises(ValueError, match="16-byte aligned"):
            getattr(dzbv, name)(widths, plane0, (None, flat[1:].view(ng, words), None))
        assert kernels.launches() == before
        out = getattr(dzbv, name)(widths, plane0, (None, flat[:-1].view(ng, words), None))
        assert kernels.launches()[name] == before[name] + 1
        torch.cuda.synchronize()
        assert not out.any()


@pytest.mark.parametrize("n", [4 * GROUP, 3 * GROUP + 17])
def test_dzbv_plane_decode_windows(cuda, n):
    """K15 on the on-disk planes of a column whose first group holds 100
    4-byte values and whose next groups hold only 4-byte values: their
    ranks start 100 bytes into a row and touch 9 rows of each of the three
    planes (110,592 B staged, the most a block takes); at 4 GROUP the last
    group's ranks end in the stream's last row, at 3 GROUP + 17 the last
    group holds 17."""
    v = dzbv_values("windows", n, rng_of(f"windows{n}")).view(np.int32)
    col = gtt.encode(v, "dzbv")
    wide = int((v.view(np.uint32) > 0xFFFFFF).sum())
    assert col.params["plane_lens"][1:] == [wide] * 3 and wide > 2 * GROUP + WINDOW_HEAD
    assert _check_dzbv(col, col.streams, v, cuda) == "dzbv_plane_decode"


@pytest.mark.parametrize("planes", [1, 2, 3])
def test_dzbv_plane_decode_past_the_grid(cuda, planes):
    """K15 over 2 * SMs + 3 groups with 100 of every tile's 128 values
    planes + 1 bytes wide (each group's ranks start mid-row): two blocks an
    SM at one or two planes, one at three, and then some."""
    ng = _staged_groups("past the grid", cuda)
    v, col = _dzbv_column(planes + 1, 100, ng)
    _check_staged("dzbv_plane_decode", col, col.streams, v, cuda)


@pytest.mark.parametrize("rows", [(1, 2, 3), (2, None, 1), (1, 1, 1), (None, None, 4), (8, 6, 4)])
def test_dzbv_plane_decode_on_random_streams(cuda, rows):
    """K15 on random width codes and plane 0 over plane streams of `rows`
    groups (None: absent), mostly far too short for the ranks the widths
    give (a rank past the stream reads its last byte), at every store width,
    against the plain version bit for bit."""
    rng = rng_of(f"plane-random/{rows}")
    ng = 5
    widths, plane0 = _words(rng, (ng, 2 * LANES), cuda), _words(rng, (ng, 8 * LANES), cuda)
    planes = tuple(None if a is None else _words(rng, (a, 8 * LANES), cuda) for a in rows)
    for store in (torch.int32, torch.int16, torch.uint8):
        before = kernels.launches()["dzbv_plane_decode"]
        got = dzbv.dzbv_plane_decode(widths, plane0, planes, store)
        assert kernels.launches()["dzbv_plane_decode"] == before + 1
        want = lanes.dzbv_plane_decode(widths, plane0, planes, store)
        torch.cuda.synchronize()
        assert torch.equal(got, want), store


def test_dzbv_plane_decode_groups_with_no_value_in_a_plane(cuda):
    """Groups with no value above one byte between groups with many: their
    windows are empty, and the next group's ranks start where the last
    non-empty group's ended."""
    rng = rng_of("plane-zero")
    v = dzbv_values("group_skewed", 5 * GROUP, rng)
    v[3 * GROUP : 3 * GROUP + 777] = rng.integers(2**24, 2**32, 777, dtype=np.uint64).astype(np.uint32)
    v[4 * GROUP + 5] = 0x1234
    col = gtt.encode(v.view(np.int32), "dzbv")
    assert col.params["plane_lens"][1:] == [GROUP + 778, GROUP + 777, GROUP + 777]
    assert _check_dzbv(col, col.streams, v.view(np.int32), cuda) == "dzbv_plane_decode"


# -- the scan epilogue: K16 filter_fold, K17 agg_fold ------------------------

SCAN_CASES = [(s, t) for s in ("nbit", "dzbf", "for") for t in SCAN_DTYPES]


def _scan_column(scheme: str, dtype: str, nullable: bool, n: int = N):
    """(values, validity or None, column) of the scan layer's inputs."""
    rng = rng_of(f"scan/{scheme}/{dtype}/{nullable}/{n}")
    v = scan_values(dtype, n, rng)
    valid = rng.random(n) > 0.1 if nullable else None
    return v, valid, gtt.encode(v, scheme, valid=valid)


def _same_value(a, b) -> bool:
    """Equal aggregates; floats by their float32 bits, so NaN equals NaN."""
    if isinstance(a, float) or isinstance(b, float):
        return np.float32(a).view(np.uint32) == np.float32(b).view(np.uint32)
    return a == b


def _scan_args(col, cuda) -> tuple:
    """(packed, refs_g, bits, kind, itemsize) of a fused column on the card."""
    streams = gtt.device_streams(col, cuda)
    dt = np_dtype(col.dtype)
    bits = col.params["bits"] if col.scheme != "dzbf" else 8 * col.params["width"]
    return streams["packed"], streams.get("refs_g"), bits, dt.kind, dt.itemsize


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("scheme,dtype", SCAN_CASES)
def test_filter_fold_matches_plain_and_oracle(cuda, scheme, dtype, nullable):
    """K16 at every op and threshold (the dtype's ends, one past them, ±0.0,
    ±Inf and NaN for floats): the words equal the plain version's bit for
    bit, pad bits included; count_where equals the oracle's count."""
    v, valid, col = _scan_column(scheme, dtype, nullable)
    packed, refs_g, bits, kind, itemsize = _scan_args(col, cuda)
    vw = nulls.valid_words_device(col, cuda) if nullable else None
    for op in OPS:
        for value in scan_thresholds(dtype, v):
            key = query._stage_key(col.dtype, value)
            before = kernels.launches()["filter_fold"]
            got = filter_.filter_fold(packed, refs_g, vw, bits, kind, itemsize, op, key)
            assert kernels.launches()["filter_fold"] == before + 1
            want = lanes.filter_fold(packed, refs_g, vw, bits, kind, itemsize, op, key)
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == torch.int32 and torch.equal(got, want)
            assert query.count_where(col, op, value, device=cuda) == int(want_mask(v, op, value, valid).sum())


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("scheme,dtype", SCAN_CASES)
def test_agg_fold_matches_plain_and_oracle(cuda, scheme, dtype, nullable):
    """K17's partials equal the plain version's bit for bit (full-range
    values: every lane's sum carries past 32 bits); sum_, min_ and max_
    equal the oracle's."""
    v, valid, col = _scan_column(scheme, dtype, nullable)
    packed, refs_g, bits, kind, itemsize = _scan_args(col, cuda)
    for name in ("sum", "min", "max"):
        vw = nulls.valid_words_device(col, cuda) if nullable and name == "sum" else None
        before = kernels.launches()["agg_fold"]
        got = agg.agg_fold(packed, refs_g, vw, bits, col.n, kind, itemsize, name)
        assert kernels.launches()["agg_fold"] == before + 1
        want = lanes.agg_fold(packed, refs_g, vw, bits, col.n, kind, itemsize, name)
        torch.cuda.synchronize()
        assert len(got) == len(want) and all(g.is_cuda and torch.equal(g, w) for g, w in zip(got, want))
        assert _same_value(getattr(aggregate, f"{name}_")(col, device=cuda), want_agg(v, name, valid))


@pytest.mark.parametrize("scheme", ["delta", "dict", "rle", "cascade", "delta2"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_scan_general_path_on_cuda(cuda, scheme, dtype):
    """Decode on the card, then the compare and the slot fold in torch ops;
    dict and cascade filter over their codes, through K16 where the code
    column is nbit, dzbf or for (dict's always; cascade's rle here)."""
    rng = rng_of(f"general/{scheme}/{dtype}")
    v = scan_values(dtype, N, rng)
    if scheme in ("dict", "cascade", "rle"):
        v = v[rng.integers(0, 40, N)]
    col = gtt.encode(v, scheme)
    for op in OPS:
        value = v[5].item()
        kernels.reset_launches()
        assert query.count_where(col, op, value, device=cuda) == int(want_mask(v, op, value).sum())
        fused_codes = scheme in ("dict", "cascade") and _codes_device_column(col).scheme in query.FUSED
        assert (kernels.launches()["filter_fold"] > 0) == fused_codes
    for name in ("sum", "min", "max"):
        assert _same_value(getattr(aggregate, f"{name}_")(col, device=cuda), want_agg(v, name))


def test_scan_of_an_empty_column_on_cuda(cuda):
    for scheme in ("nbit", "for", "dict"):
        col = gtt.encode(np.zeros(0, np.int32), scheme)
        kernels.reset_launches()
        assert query.count_where(col, "ge", 0, device=cuda) == 0
        assert not any(kernels.launches().values())
        assert aggregate.sum_(col, device=cuda) == 0
        with pytest.raises(ValueError, match="empty"):
            aggregate.min_(col, device=cuda)


def test_scan_wrappers_reject_tensors_on_two_devices(cuda):
    col = gtt.encode(np.arange(N, dtype=np.int32), "for")
    packed, refs_g, bits, kind, itemsize = _scan_args(col, cuda)
    with pytest.raises(ValueError):
        filter_.filter_fold(packed, refs_g.cpu(), None, bits, kind, itemsize, "lt", 5)
    with pytest.raises(ValueError):
        agg.agg_fold(packed, refs_g, torch.zeros((packed.shape[0], 1024), dtype=torch.int32), bits, col.n, kind,
                     itemsize, "sum")


def _words(rng, shape, cuda) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(cuda)


@pytest.mark.parametrize("groups", ["one", "past the grid"])
@pytest.mark.parametrize("bits", range(1, 33))
def test_scan_folds_at_every_width(cuda, bits, groups):
    """K16 at each kind with two ops and K17 sum/min/max equal their plain
    versions bit for bit at B = 1..32, with and without FOR refs and
    validity words, n = ng * GROUP - 5: on one group, and on more tiles
    than the persistent grid has blocks (not a multiple of it)."""
    rng = rng_of(f"fold/{bits}/{groups}")
    ng = 1 if groups == "one" else torch.cuda.get_device_properties(cuda).multi_processor_count + 3
    n = ng * GROUP - 5
    packed = _words(rng, (ng, bits * LANES), cuda)
    first = lanes.lmp_unpack(packed[:1], bits).reshape(-1)[:1]
    for refs_g in (None, _words(rng, (ng,), cuda)):
        u0 = first if refs_g is None else lanes.wrap32(first.to(torch.int64) + refs_g[:1])
        for vw in (None, _words(rng, (ng, LANES), cuda)):
            for kind, itemsize in (("u", 4), ("i", 2), ("f", 4)):
                keys = {"lt": int(rng.integers(-(2**31), 2**31)),
                        "eq": int(lanes.order_key(u0, kind, itemsize)[0])}
                for op, key in keys.items():
                    before = kernels.launches()["filter_fold"]
                    got = filter_.filter_fold(packed, refs_g, vw, bits, kind, itemsize, op, key)
                    assert kernels.launches()["filter_fold"] == before + 1
                    want = lanes.filter_fold(packed, refs_g, vw, bits, kind, itemsize, op, key)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (kind, op, refs_g is None, vw is None)
                for name in ("sum", "min", "max"):
                    w = vw if name == "sum" else None
                    got = agg.agg_fold(packed, refs_g, w, bits, n, kind, itemsize, name)
                    want = lanes.agg_fold(packed, refs_g, w, bits, n, kind, itemsize, name)
                    torch.cuda.synchronize()
                    assert all(torch.equal(g, x) for g, x in zip(got, want)), (kind, name, refs_g is None, vw is None)


def test_scan_wrappers_reject_misaligned_words(cuda):
    """The bulk copies of K16/K17 need 16-byte aligned packed and validity
    words: a view 4 bytes off raises, and nothing launches."""
    ng, bits = 2, 9
    flat = torch.zeros(ng * bits * LANES + 1, dtype=torch.int32, device=cuda)
    packed = flat[1:].view(ng, bits * LANES)
    valid = torch.zeros(ng * LANES + 1, dtype=torch.int32, device=cuda)[1:].view(ng, LANES)
    aligned = flat[:-1].view(ng, bits * LANES)
    before = kernels.launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        filter_.filter_fold(packed, None, None, bits, "i", 4, "lt", 5)
    with pytest.raises(ValueError, match="16-byte aligned"):
        agg.agg_fold(packed, None, None, bits, ng * GROUP, "i", 4, "min")
    with pytest.raises(ValueError, match="16-byte aligned"):
        agg.agg_fold(aligned, None, valid, bits, ng * GROUP, "i", 4, "sum")
    assert kernels.launches() == before
    assert _wrap.walk_args(aligned, None, bits)[1] <= ng * _wrap.TILES_PER_GROUP


# -- K19 run_filter: predicates on rle / rpe run tables -----------------------


def _run_general(ends, vals, ng, kind, itemsize, op, key):
    """The general path on the card: K5's decode, the compare, pack_hits."""
    return lanes.pack_hits(query._cmp(rle.run_expand(ends, vals, ng), key, op, kind, itemsize))


@pytest.mark.parametrize("tiles", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("w_pad", [8, 16, 32, 128])
def test_run_filter_matches_general_path(cuda, w_pad, tiles):
    """K19 against the general path (K5, compare, pack) word for word, pad
    bits included, on every hand-made table of three groups (the last one's
    second half of tiles all pad), at every dtype, op and threshold, and
    with validity words; each call one K19 launch and no K5 launch."""
    for case in RUN_TABLE_CASES:
        ends, _ = run_tables(case, w_pad, tiles, 3, seed=w_pad + tiles)
        e = torch.from_numpy(ends).to(cuda)
        for dtype in SCAN_DTYPES:
            rng = rng_of(f"k19/{case}/{w_pad}/{tiles}/{dtype}")
            vals, v = run_table_values(dtype, ends.shape, rng)
            u, vw = torch.from_numpy(vals).to(cuda), _words(rng, (3, LANES), cuda)
            kind, itemsize = np_dtype(dtype).kind, np_dtype(dtype).itemsize
            for op in OPS:
                for value in scan_thresholds(dtype, v):
                    key = query._stage_key(dtype, value)
                    want = _run_general(e, u, 3, kind, itemsize, op, key)
                    before = kernels.launches()
                    got = run_filter.run_filter(e, u, None, 3, kind, itemsize, op, key)
                    after = kernels.launches()
                    assert after["run_filter"] == before["run_filter"] + 1
                    assert after["run_expand"] == before["run_expand"]
                    torch.cuda.synchronize()
                    assert got.is_cuda and torch.equal(got, want), (case, dtype, op, value)
                got = run_filter.run_filter(e, u, vw, 3, kind, itemsize, op, key)
                assert torch.equal(got, want & vw), (case, dtype, op, "valid")


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("dtype", SCAN_DTYPES)
@pytest.mark.parametrize("scheme", ["rle", "rpe"])
def test_run_filter_on_run_columns(cuda, scheme, dtype, nullable):
    """query.filter_bitmap on rle and rpe columns in tile form: one K19
    launch a predicate and no K5, the words equal to the general path's on
    the same streams (validity ANDed in), count_where equal to the
    oracle's."""
    rng = rng_of(f"k19/column/{scheme}/{dtype}/{nullable}")
    v = scan_runs(dtype, N, rng)
    valid = rng.random(N) > 0.1 if nullable else None
    col = gtt.encode(v, scheme, valid=valid)
    streams = gtt.device_streams(col, cuda)
    w_pad = streams["vals_w"].shape[-1]
    ends, vals = streams["ends_w"].reshape(-1, w_pad), streams["vals_w"].reshape(-1, w_pad)
    vw = nulls.valid_words_device(col, cuda) if nullable else None
    dt = np_dtype(col.dtype)
    for op in OPS:
        for value in scan_thresholds(dtype, v):
            want = _run_general(ends, vals, -(-col.n // GROUP), dt.kind, dt.itemsize, op,
                                query._stage_key(col.dtype, value))
            kernels.reset_launches()
            got = query.filter_bitmap(col, op, value, device=cuda, streams=streams)
            assert kernels.launches()["run_filter"] == 1 and kernels.launches()["run_expand"] == 0
            torch.cuda.synchronize()
            assert torch.equal(got, want if vw is None else want & vw), (op, value)
            assert query.count_where(col, op, value, device=cuda) == int(want_mask(v, op, value, valid).sum())


def test_run_filter_on_a_clustered_date_column(cuda):
    """A yyyymmdd date column clustered on its key, 2^26 rows in runs of
    ~250k (the tile form of one tile a group that SSB's lo_orderdate takes):
    count_between over a year, a month, a week and a day against NumPy's
    count, two K19 launches each and no K5."""
    n = 2**26
    rng = rng_of("k19/dates")
    days = np.datetime64("1992-01-01") + np.arange(n // 200_000 + 1)
    ymd = days.astype("datetime64[D]").astype(object)
    dates = np.array([d.year * 10000 + d.month * 100 + d.day for d in ymd], np.int32)
    v = np.repeat(dates, rng.integers(200_000, 300_000, dates.size))[:n]
    col = gtt.encode(v, "rle")
    streams = gtt.device_streams(col, cuda)
    assert "vals_w" in streams and streams["vals_w"].shape[-2:] == (1, 8)
    for lo, hi in ((19920101, 19921231), (19920301, 19920331), (19920407, 19920413), (19920510, 19920510),
                   (int(v[0]), int(v[-1]))):
        kernels.reset_launches()
        assert query.count_between(col, lo, hi, device=cuda) == int(((v >= lo) & (v <= hi)).sum()), (lo, hi)
        assert kernels.launches()["run_filter"] == 2 and kernels.launches()["run_expand"] == 0


def test_run_filter_leaves_the_scatter_form_to_the_general_path(cuda):
    """Runs of ~2 take the scatter form: the general path (K6) answers."""
    v = np.repeat(rng_of("k19/scatter").integers(-50, 50, N // 2 + 1), 2)[:N].astype(np.int32)
    col = gtt.encode(v, "rle")
    kernels.reset_launches()
    assert query.count_where(col, "lt", 7, device=cuda) == int((v < 7).sum())
    assert kernels.launches()["run_filter"] == 0 and kernels.launches()["cumsum_rows"] == 1


# -- device encode: K18 lmp_pack and the encoders around it ------------------

PACK_CASES = [("none", GROUP), ("for_sub", GROUP), ("for_sub", 2 * GROUP), ("delta_zigzag", GROUP)]


@pytest.mark.parametrize("prologue,frame_len", PACK_CASES)
@pytest.mark.parametrize("bits", range(1, 33))
def test_lmp_pack_matches_plain(cuda, bits, prologue, frame_len):
    """K18 at every width and prologue against its plain version (and the
    NumPy packer for ``none``), on values of the width, the FOR references
    at both ends of the range, a ragged delta length."""
    rng = rng_of(f"pack/{bits}/{prologue}/{frame_len}")
    u = rng.integers(0, 2**bits, 4 * GROUP, dtype=np.uint64).astype(np.uint32)
    values = torch.from_numpy(u.view(np.int32)).to(cuda).view(4, GROUP)
    refs = None
    if prologue == "for_sub":
        refs = torch.tensor([-(2**31), 2**31 - 1, 5, -1][: 4 // (frame_len // GROUP)], dtype=torch.int32, device=cuda)
    before = kernels.launches()["lmp_pack"]
    got = encode.lmp_pack(values, bits, prologue, refs, N, frame_len)
    assert kernels.launches()["lmp_pack"] == before + 1
    want = lanes.lmp_pack(values, bits, prologue, refs, N, frame_len)
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == (4, bits * 1024) and torch.equal(got, want)
    if prologue == "none":
        assert got.cpu().numpy().view(np.uint32).tobytes() == ref_lmp.lmp_pack(u, bits).tobytes()


def _decodes_on_cuda(col, v: np.ndarray, cuda) -> None:
    assert gtt.decode(col, device=cuda).cpu().numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize("n", [0, 1, N])
@pytest.mark.parametrize("dtype", ["int8", "int16", "uint16", "int32", "float32"])
def test_encode_nbit_device_on_cuda(cuda, dtype, n):
    dt = np.dtype(dtype)
    u = rng_of(f"nbit/{dtype}/{n}").integers(0, 2 ** (8 * dt.itemsize), n, dtype=np.uint64)
    v = u.astype(np.dtype(f"uint{8 * dt.itemsize}")).view(dt)
    kernels.reset_launches()
    col = encode.encode_nbit_device(v, bits=8 * dt.itemsize, name="c")
    assert kernels.launches()["lmp_pack"] == 1
    assert_same_column(col, gtt.encode(v, "nbit", bits=8 * dt.itemsize, name="c"))
    _decodes_on_cuda(col, v, cuda)


@pytest.mark.parametrize("frame_len", [GROUP, 2 * GROUP])
def test_for_streams_device_on_cuda(cuda, frame_len):
    v = for_values(N, rng_of(f"for/{frame_len}"))
    host = gtt.encode(v, "for", frame_len=frame_len)
    u = pad_to_groups(v.view(np.uint32), fill=int(v.view(np.uint32)[-1]))
    nf = -(-u.shape[0] // frame_len)
    u = np.concatenate([u, np.full(nf * frame_len - u.shape[0], u[-1], np.uint32)])
    packed, refs = encode.for_streams_device(torch.from_numpy(u.view(np.int32)).to(cuda), host.params["bits"], frame_len)
    ng = host.streams["packed"].shape[0]
    assert packed.is_cuda and packed.shape[0] == nf * frame_len // GROUP
    assert packed[:ng].cpu().numpy().view(np.uint32).tobytes() == host.streams["packed"].tobytes()
    assert refs.cpu().numpy().tobytes() == host.streams["refs"].tobytes()


@pytest.mark.parametrize("data", ["wrapping walk", "timestamps"])
def test_delta_streams_device_on_cuda(cuda, data):
    n = 3 * GROUP + 11
    rng = rng_of(f"delta/{data}")
    v = wrapping_walk(n, rng) if data == "wrapping walk" else (np.cumsum(rng.integers(0, 8, n)) + 1_600_000_000).astype(np.int32)
    host = gtt.encode(v, "delta")
    u = torch.from_numpy(pad_to_groups(v.view(np.uint32)).view(np.int32)).to(cuda)
    packed, anchors = encode.delta_streams_device(u, host.params["bits"], n=n)
    assert packed.cpu().numpy().view(np.uint32).tobytes() == host.streams["packed"].tobytes()
    assert anchors.cpu().numpy().tobytes() == host.streams["anchors"].tobytes()


@pytest.mark.parametrize("case", ["long", "distinct", "equal", "one", "empty"])
def test_encode_rle_device_on_cuda(cuda, case):
    rng = rng_of(f"rle/{case}")
    v = {"long": _run_values("long", rng), "distinct": np.arange(N, dtype=np.int32), "equal": np.full(N, -7, np.int32),
         "one": np.array([5], np.int32), "empty": np.zeros(0, np.int32)}[case]
    col = encode.encode_rle_device(v, name="c")
    assert_same_column(col, gtt.encode(v, "rle", name="c"))
    _decodes_on_cuda(col, v, cuda)


@pytest.mark.parametrize("kind", DICT_KINDS)
def test_encode_dict_device_on_cuda(cuda, kind):
    v = dict_values(kind, N, rng_of(f"dict/{kind}"))
    kernels.reset_launches()
    col = encode.encode_dict_device(v, name="c")
    assert kernels.launches()["lmp_pack"] == 1
    assert_same_column(col, gtt.encode(v, "dict", name="c"))
    _decodes_on_cuda(col, v, cuda)
    empty = v[:0]
    kernels.reset_launches()
    assert_same_column(encode.encode_dict_device(empty, name="c"), gtt.encode(empty, "dict", name="c"))
    assert not any(kernels.launches().values())


def test_lmp_pack_rejects_bad_arguments_on_cuda(cuda):
    values = torch.zeros((2, GROUP), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        encode.lmp_pack(values, 9, "for_sub", refs=torch.zeros(2, dtype=torch.int32))  # refs on the CPU
    with pytest.raises(ValueError):
        encode.lmp_pack(values, 33)
    with pytest.raises(ValueError):
        encode.lmp_pack(values[:, 1:], 9)


# -- 64-bit and string columns, partial decode, zone maps, GROUP BY, top-k --
# Each new path on the card against the same call on the CPU (whose plain
# versions the CPU tests hold to the JAX package), and the launches it made.


def _same(a, b) -> bool:
    """Equal results of the new paths: tensors and arrays by dtype, shape and
    bytes (object arrays by element), tuples and GroupResults field by
    field, scalars by type and value (floats by their bits)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    if isinstance(a, np.ndarray):
        if a.dtype == object:
            return b.dtype == object and a.shape == b.shape and all(
                type(x) is type(y) and x == y for x, y in zip(a.reshape(-1), b.reshape(-1)))
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if hasattr(a, "__dataclass_fields__"):
        return all((getattr(a, f) is None and getattr(b, f) is None) or _same(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    if isinstance(a, float):
        return type(b) is float and np.float64(a).view(np.uint64) == np.float64(b).view(np.uint64)
    return type(a) is type(b) and a == b


def _on_card_like_cpu(cuda, fn, expect: tuple = ()):
    """fn(device) on the card equals fn on the CPU, and the card run
    launched every kernel of ``expect``."""
    kernels.reset_launches()
    got = fn(cuda)
    torch.cuda.synchronize()
    launched = {k: c for k, c in kernels.launches().items() if c}
    assert all(launched.get(k) for k in expect), launched
    want = fn(torch.device("cpu"))
    assert _same(got, want)
    return got


@pytest.mark.parametrize("kind", WIDE_KINDS)
def test_wide_paths_on_card_match_cpu(cuda, kind):
    from giddy_tpu_torch import partial, topk, wide, zonemap

    rng = rng_of(f"cuda/wide/{kind}")
    v = wide_values(kind, N, rng)
    valid = rng.random(N) > 0.1 if kind == "orderkey" else None
    col = gtt.encode(v, "wide", valid=valid, base_scheme="delta" if kind == "orderkey" else "nbit", hi_scheme="nbit")
    out = _on_card_like_cpu(cuda, lambda d: gtt.decode(col, device=d), ("lmp_unpack",))
    assert out.is_cuda and out.dtype == wide.TORCH_DTYPES[col.dtype]
    _on_card_like_cpu(cuda, lambda d: gtt.decode_columns([col], device=d)["col"])
    fv = v if valid is None else nulls.fill_nulls(v, valid)
    for op in OPS:
        for value in wide_thresholds(fv)[:2]:
            _on_card_like_cpu(cuda, lambda d: query.filter_bitmap(col, op, value, device=d))
    _on_card_like_cpu(cuda, lambda d: query.isin_bitmap(col, list(fv[:20]), device=d))
    for fn in ("sum_", "min_", "max_", "avg_", "distinct_count"):
        _on_card_like_cpu(cuda, lambda d: getattr(aggregate, fn)(col, device=d))
    idx = rng.integers(0, N, 100)
    _on_card_like_cpu(cuda, lambda d: partial.take(col, idx, device=d))
    _on_card_like_cpu(cuda, lambda d: partial.decode_groups(col, 1, 3, device=d))
    _on_card_like_cpu(cuda, lambda d: topk.top_k(col, 50, device=d))
    if kind == "orderkey":
        _on_card_like_cpu(cuda, lambda d: zonemap.count_where_pruned(col, "lt", int(fv[N // 2]), device=d))
        _on_card_like_cpu(cuda, lambda d: zonemap.searchsorted(col, fv[idx], device=d))
        _on_card_like_cpu(cuda, lambda d: query.select_where(col, "lt", int(fv[100]), device=d))


@pytest.mark.parametrize("kind", list(STRING_KINDS))
def test_string_paths_on_card_match_cpu(cuda, kind):
    from giddy_tpu_torch import strings

    vals = string_values(kind, N, rng_of(f"cuda/strings/{kind}"))
    col = strings.encode_strings(vals, valid=np.arange(N) % 9 != 0 if kind == "priority" else None)
    assert col.params["codes_scheme"] == STRING_KINDS[kind]
    got = _on_card_like_cpu(cuda, lambda d: strings.decode(col, device=d))
    assert got.dtype == object and (kind == "priority" or list(got) == vals)
    mid = vals[N // 2]
    for op, value in (("eq", mid), ("lt", mid), ("ge", mid), ("startswith", mid[:4]), ("contains", mid[2:4])):
        _on_card_like_cpu(cuda, lambda d: strings.filter_bitmap_str(col, op, value, device=d))
    dic = strings.dictionary(col)
    for picks in (list(dic[:2]), list(dic[::2])):
        _on_card_like_cpu(cuda, lambda d: strings.isin_bitmap_str(col, picks, device=d))
    _on_card_like_cpu(cuda, lambda d: strings.select_where_str(col, "lt", vals[N // 3], device=d))


@pytest.mark.parametrize("scheme,kind", [
    ("nbit", None), ("for", None), ("delta", None), ("delta2", None), ("xordelta", None), ("dict", None),
    ("rle", None), ("rle", "dense"), ("rpe", None), ("model", None), ("bitmap", None), ("raw", None),
    ("alp", None), ("cascade", None), ("patched", None), ("patched", "compressed"),
    ("dzbv", "mixed"), ("dzbv", "skewed"), ("dzbv", "group_skewed"),
])
def test_partial_decode_on_card_matches_cpu(cuda, scheme, kind):
    from giddy_tpu_torch import partial
    from giddy_tpu_torch.datagen import gen_column

    rng = rng_of(f"cuda/partial/{scheme}/{kind}")
    if scheme == "dzbv":
        v = dzbv_values(kind, N, rng).view(np.int32)
    elif kind == "dense":
        v = _run_values("dense", rng)
    else:
        v = gen_column(scheme, N, rng)
    col = gtt.encode(v, scheme, **({"kind": "compressed"} if kind == "compressed" else {}))
    for g0, g1 in ((0, 1), (1, 3), (0, 4)):
        got = _on_card_like_cpu(cuda, lambda d: partial.decode_groups(col, g0, g1, device=d))
        assert got.tobytes() == v[g0 * GROUP : g1 * GROUP].tobytes()
    idx = rng.integers(0, N, 200)
    assert _on_card_like_cpu(cuda, lambda d: partial.take(col, idx, device=d)).tobytes() == v[idx].tobytes()


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("keys,vals", [
    ("dict", "int32"), ("strdict", "int16"), ("cascade", "float32"), ("dict", "uint32"), ("strdict", "wide-int64"),
    ("dict", "wide-float64"),
])
def test_group_reduce_on_card_matches_cpu(cuda, keys, vals, filtered):
    from giddy_tpu_torch import groupby, strings

    rng = rng_of(f"cuda/groupby/{keys}/{vals}")
    if keys == "strdict":
        kcol = strings.encode_strings(string_values("priority", N, rng))
    else:
        kcol = gtt.encode(rng.integers(-500, 500, 1000)[rng.integers(0, 1000, N)].astype(np.int32), keys)
    if vals.startswith("wide"):
        vcol = gtt.encode(wide_values(vals[5:], N, rng), "wide")
    else:
        vcol = gtt.encode(scan_values(vals, N, rng), "nbit", valid=rng.random(N) > 0.05)
    bm = None
    if filtered:
        bm = query.filter_bitmap(gtt.encode(scan_values("int32", N, rng), "nbit"), "lt", 0, device=cuda)
    _on_card_like_cpu(cuda, lambda d: groupby.group_reduce(
        kcol, vcol, ("count", "sum", "min", "max"), None if bm is None else bm.to(d), device=d), ("lmp_unpack",))
    _on_card_like_cpu(cuda, lambda d: groupby.group_count(kcol, device=d))
    if keys != "strdict":  # the code counts of a dictionary column's sum
        _on_card_like_cpu(cuda, lambda d: aggregate.sum_(kcol, device=d))


@pytest.mark.parametrize("dtype", ["int32", "int8", "uint16", "float32"])
def test_top_k_on_card_matches_cpu(cuda, dtype):
    """Equal keys come back lowest position first on the card too: int8 and
    uint16 draw from seven values, so every selection ties."""
    from giddy_tpu_torch import topk

    rng = rng_of(f"cuda/topk/{dtype}")
    v = scan_values(dtype, N, rng)
    if dtype in ("int8", "uint16"):
        v = v[rng.integers(0, 7, N)]
    col = gtt.encode(v, "nbit", valid=rng.random(N) > 0.1 if dtype == "float32" else None)
    for k, largest in ((100, True), (100, False), (5000, False)):
        _on_card_like_cpu(cuda, lambda d: topk.top_k(col, k, largest=largest, device=d), ("lmp_unpack",))
    _on_card_like_cpu(cuda, lambda d: topk.order_by(col, ascending=False, device=d))


def test_zonemap_and_layout_on_card_match_cpu(cuda):
    from giddy_tpu_torch import layout, zonemap

    rng = rng_of("cuda/zonemap")
    v = np.sort(rng.integers(-(2**31), 2**31, N, dtype=np.int64)).astype(np.int32)
    col = gtt.encode(v, "delta")
    for op in OPS:
        _on_card_like_cpu(cuda, lambda d: zonemap.count_where_pruned(col, op, int(v[N // 2]), device=d))
    q = v[rng.integers(0, N, 50)]
    for side in ("left", "right"):
        _on_card_like_cpu(cuda, lambda d: zonemap.searchsorted(col, q, side=side, device=d))
    bits = torch.from_numpy((rng.random(N) < 0.1).astype(np.int32))
    _on_card_like_cpu(cuda, lambda d: layout.bitmap_to_indices(bits.to(d), 8192))
    idx = torch.from_numpy(rng.permutation(N).astype(np.int32))
    data = torch.from_numpy(v)
    _on_card_like_cpu(cuda, lambda d: layout.gather(data.to(d), idx.to(d)))
    _on_card_like_cpu(cuda, lambda d: layout.scatter(torch.zeros(N, dtype=torch.int32, device=d), idx.to(d), data.to(d)))
    _on_card_like_cpu(cuda, lambda d: layout.indices_to_bitmap(idx[:100].to(d), N))


# -- the table engine: stream, advisor, table, join, dataset, cli, selftest ----


@pytest.mark.parametrize("kind", ["nbit", "for", "delta", "dict", "rle", "cascade", "dzbv", "patched", "alp",
                                  "wide", "nullable"])
def test_stream_on_card_matches_decode(cuda, kind):
    """Streamed chunks (pinned staging, the copy stream) equal the
    whole-column decode on the card, chunk for chunk; the streamed counts
    equal count_where on the card and the CPU's."""
    from giddy_tpu_torch import stream
    from giddy_tpu_torch.datagen import gen_column

    rng = rng_of(f"cuda/stream/{kind}")
    n = 5 * GROUP + 321
    if kind == "wide":
        v = wide_values("orderkey", n, rng)
        col = gtt.encode(v, "wide", base_scheme="delta", hi_scheme="nbit")
    elif kind == "nullable":
        v = gen_column("for", n, rng)
        col = gtt.encode(v, "for", valid=rng.random(n) > 0.1)
    else:
        v = gen_column(kind, n, rng)
        col = gtt.encode(v, kind)
    whole = gtt.decode(col, device=cuda).cpu().numpy()
    chunks = list(stream.stream_decode(col, chunk_groups=2, device=cuda))
    assert [c.shape[0] for c in chunks] == [2 * GROUP, 2 * GROUP, GROUP + 321]
    if kind != "wide":
        assert all(c.is_cuda for c in chunks)
    host = np.concatenate([c.cpu().numpy() if isinstance(c, torch.Tensor) else c for c in chunks])
    assert host.tobytes() == whole.tobytes() == stream.decode_streamed(col, chunk_groups=3, device=cuda).tobytes()
    pivot = v[n // 2].item()
    for op in ("lt", "eq", "ne"):
        got = _on_card_like_cpu(cuda, lambda d: stream.stream_count_where(col, op, pivot, chunk_groups=2, device=d))
        assert got == query.count_where(col, op, pivot, device=cuda)


def test_advisor_on_card(cuda):
    from giddy_tpu_torch import advisor
    from giddy_tpu_torch.datagen import gen_column

    v = gen_column("delta", 4 * GROUP, rng_of("cuda/advisor"))
    assert advisor._measure_decode_gbps(v, "delta", device=cuda) > 0.0
    plain, measured = advisor.suggest(v), advisor.suggest(v, measure=True, device=cuda)
    assert dict(plain) == dict(measured)
    assert gtt.container_bytes([gtt.encode(v, "auto")]) == gtt.container_bytes([advisor.encode_best(v, ranked=plain)])


def _table_arrays(n: int = N) -> dict:
    rng = rng_of(f"cuda/table/{n}")
    return {
        "x": rng.integers(-(2**19), 2**19, n).astype(np.int32),
        "price": np.round(rng.uniform(0, 500, n), 2).astype(np.float32),
        "ts": (1_700_000_000_000 + np.cumsum(rng.integers(0, 50, n))).astype(np.int64),
        "prio": np.array([PRIORITIES[i] for i in rng.integers(0, 5, n)], dtype=object),
        "k": rng.integers(0, 17, n).astype(np.int32) * 3,
        "nx": (rng.integers(0, 100, n).astype(np.int32), rng.random(n) > 0.15),
    }


def test_table_on_card_matches_cpu(cuda):
    from giddy_tpu_torch.table import Table

    a = _table_arrays()
    cpu = torch.device("cpu")
    t = {d: Table.from_arrays(a, {"k": "dict"}, device=d) for d in (cuda, cpu)}
    assert t[cuda].to_bytes() == t[cpu].to_bytes()

    def on(fn, expect=()):
        return _on_card_like_cpu(cuda, lambda d: fn(t[d]), expect)

    preds = [("x", "lt", 0), ("price", "between", (10.0, 20.0)), ("ts", "gt", int(a["ts"][N // 2])),
             ("prio", "eq", "2-HIGH"), ("k", "isin", [3, 9, 30]), ("x", "isin", list(range(-50, 50, 7))),
             ("nx", "le", 40)]
    for p in preds:
        on(lambda tb: tb.where(*p))
    on(lambda tb: tb.where_all(*preds[:3]), ("delta_decode", "alp_decode", "lmp_unpack"))
    on(lambda tb: tb.where_any(*preds[3:]))
    on(lambda tb: tb.count(preds[3], preds[6]), ("filter_fold",))
    for name, agg in (("x", "sum"), ("x", "min"), ("price", "sum"), ("ts", "max"), ("nx", "avg"), ("prio", "min"),
                      ("k", "distinct"), ("price", "distinct")):
        on(lambda tb: tb.agg(name, agg))
    on(lambda tb: tb.groupby("k", "x", ("count", "sum", "min", "max"), ("nx", "ge", 5)))
    on(lambda tb: tb.groupby(["prio", "k"], "price", ("count", "sum")))
    on(lambda tb: tb.select(["x", "prio", "ts"], tb.where("x", "ge", 500_000)))
    on(lambda tb: tb.top_k("price", 20, select=["prio", "ts"]))
    on(lambda tb: tb.sort_by(["k", "price"], ascending=[True, False]).to_bytes())
    on(lambda tb: tb.filter(("prio", "eq", "1-URGENT")).to_bytes())
    build = {d: Table.from_arrays({"kk": np.array([3, 6, 7, 48], np.int32)}, device=d) for d in (cuda, cpu)}
    for probe in ("k", "x"):
        on(lambda tb: tb.semi_join(probe, build[tb.device], "kk"))
        on(lambda tb: tb.anti_join(probe, build[tb.device], "kk"))


@pytest.mark.parametrize("kind", ["int32", "float32", "wide", "dict", "strdict", "nullable"])
def test_join_on_card_matches_cpu(cuda, kind):
    """join_indices on the card (the prunes' scans there) gives the CPU's
    pairs in the CPU's order, for every join type."""
    from giddy_tpu_torch import join, strings

    cols = []
    for side, (lo, hi) in (("left", (0, 3000)), ("right", (2000, 6000))):
        rng = rng_of(f"cuda/join/{kind}/{side}")
        v = rng.integers(lo, hi, N)
        if kind == "strdict":
            cols.append(strings.encode_strings([f"k{x}" for x in v], name="key"))
        elif kind == "float32":
            cols.append(gtt.encode((v / 8.0).astype(np.float32), "raw", name="key"))
        elif kind == "wide":
            cols.append(gtt.encode(v.astype(np.int64) * 2**33, "wide", name="key"))
        else:
            cols.append(gtt.encode(v.astype(np.int32), "dict" if kind == "dict" else "nbit", name="key",
                                   valid=rng.random(N) > 0.1 if kind == "nullable" else None))
    for how in ("inner", "left", "outer"):
        _on_card_like_cpu(cuda, lambda d: join.join_indices(*cols, how=how, device=d))
    _on_card_like_cpu(cuda, lambda d: join.anti_join_bitmap(*cols, device=d))


def test_dataset_on_card_matches_cpu(cuda, tmp_path):
    """A dataset written on the card has the CPU-written one's files; its
    scans on the card equal the CPU's."""
    import os

    from giddy_tpu_torch.dataset import Dataset
    from giddy_tpu_torch.table import Table

    parts = []
    for i in range(3):
        a = _table_arrays()
        a["x"] = a["x"] + i * 2**20
        parts.append(a)
    cpu = torch.device("cpu")
    for d, sub in ((cuda, "card"), (cpu, "host")):
        Dataset.write(str(tmp_path / sub), [Table.from_arrays(a, {"k": "dict"}, device=d) for a in parts], device=d)
    for name in os.listdir(tmp_path / "host"):
        assert (tmp_path / "card" / name).read_bytes() == (tmp_path / "host" / name).read_bytes(), name
    ds = {d: Dataset.open(str(tmp_path / "host"), device=d) for d in (cuda, cpu)}

    def on(fn):
        return _on_card_like_cpu(cuda, lambda d: fn(ds[d]))

    on(lambda s: s._plan([("x", "lt", 2**19)]))
    on(lambda s: s.count(("x", "lt", 2**19), ("prio", "ne", "5-LOW")))
    for agg in ("sum", "min", "max", "count", "distinct"):
        on(lambda s: s.agg("x", agg))
    on(lambda s: s.groupby("k", "nx", ("count", "sum", "min", "max")))
    on(lambda s: s.select(["x", "prio"], ("x", "ge", 2**21 + 2**19 - 100)))
    compacted = iter(("compact_card", "compact_host"))
    on(lambda s: s.compact(str(tmp_path / next(compacted)), rows_per_partition=2 * N).part(0).to_bytes())


def test_cli_on_card_matches_cpu(cuda, tmp_path, capsys):
    from giddy_tpu_torch import cli

    np.save(tmp_path / "v.npy", scan_values("int32", N, rng_of("cuda/cli")))
    cli.main(["encode", str(tmp_path / "v.npy"), "auto", "--out", str(tmp_path / "v.gtp"), "--measure",
              "--device", str(cuda)])
    capsys.readouterr()
    for argv in (["query", str(tmp_path / "v.gtp"), "--op", "lt", "--value", "0"],
                 ["agg", str(tmp_path / "v.gtp"), "sum"], ["agg", str(tmp_path / "v.gtp"), "max"],
                 ["validate", str(tmp_path / "v.gtp")]):
        outs = []
        for d in (str(cuda), "cpu"):
            try:
                cli.main(argv + ["--device", d])
            except SystemExit as e:
                assert e.code == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0]
    for d, out in ((str(cuda), "card.npy"), ("cpu", "host.npy")):
        cli.main(["decode", str(tmp_path / "v.gtp"), "--device", d, "--out", str(tmp_path / out)])
    assert (tmp_path / "card.npy").read_bytes() == (tmp_path / "host.npy").read_bytes()


def test_selftest_on_card(cuda):
    from giddy_tpu_torch import selftest

    r = selftest.run_selftest(2 * GROUP + 999, device=cuda)
    assert r["pass"], {k: v.get("error") for k, v in r["schemes"].items() if not v["exact"]}
    assert r["device"] == "cuda" and r["device_kind"] == torch.cuda.get_device_name(0)
    for scheme in selftest.SCHEMES:  # the audit ran on the card for every core scheme
        e = r["schemes"][scheme]
        assert e["temp_bytes"] == 0 and e["traffic_vs_ideal"] == 1.0 and e["traffic_vs_sol"] <= SOL_CAP, (scheme, e)


# The single-pass cap of the reference's audit (tests/test_roofline.py
# SOL_CAP): traffic over compressed + padded output. A ratio r caps the
# decode at 1/r of speed of light.
SOL_CAP = 1.15


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_traffic_audit_single_pass(cuda, scheme):
    """Every core scheme's decoder, as ``decode`` dispatches it, allocates
    nothing but its output (temp_bytes == 0) and its traffic stays within
    SOL_CAP of compressed + decoded bytes."""
    from giddy_tpu_torch import roofline
    from giddy_tpu_torch.datagen import gen_column

    col = gtt.encode(gen_column(scheme, 8 * GROUP, rng_of(f"cuda/audit/{scheme}")), scheme)
    a = roofline.traffic_audit(col, cuda)
    assert a["interpreted"] is False and a["out_bytes"] == 8 * GROUP * 4
    assert a["temp_bytes"] == 0 and a["ratio"] == 1.0 and a["traffic_bytes"] == a["ideal_bytes"], a
    assert a["sol_ratio"] <= SOL_CAP, a


def test_traffic_audit_sees_a_temporary(cuda):
    """The audit counts what a decoder allocates beside its output: rle's
    scatter form (runs of ~4) scatters into a dense (ng, GROUP) int32 array
    before K6, which shows as at least n_pad * 4 temporary bytes."""
    from giddy_tpu_torch import roofline

    col = gtt.encode(_run_values("dense", rng_of("cuda/audit/dense")), "rle")
    assert "pos" in gtt.device_streams(col, cuda)
    a = roofline.traffic_audit(col, cuda)
    assert a["temp_bytes"] >= a["out_bytes"] and a["ratio"] > SOL_CAP, a


def test_traffic_audit_leaves_out_the_allocators_slack(cuda):
    """The caching allocator may serve the output from a cached block up to
    1 MB larger than it (380,928 such bytes under delta2 at n = 2^22 + 999
    on an NVIDIA H100 80GB HBM3): that block is the output's, not a
    temporary."""
    from giddy_tpu_torch import roofline
    from giddy_tpu_torch.datagen import gen_column

    n = 40 * GROUP
    col = gtt.encode(gen_column("delta2", n, rng_of("cuda/audit/slack")), "delta2")
    torch.cuda.empty_cache()
    spare = torch.empty(n * 4 + 380_928, dtype=torch.uint8, device=cuda)
    del spare  # cached: the decoder's output takes it whole
    a = roofline.traffic_audit(col, cuda)
    assert a["temp_bytes"] == 0 and a["out_bytes"] == n * 4, a


def test_chip_bw_of_this_card(cuda):
    from giddy_tpu_torch import roofline

    assert roofline.chip_bw() == roofline.HBM_BW[torch.cuda.get_device_name()]


SHARDED_SCHEMES = ["nbit", "for", "delta", "dict", "rle", "patched", "alp", "dzbv", "cascade", "bitmap"]


@pytest.mark.parametrize("scheme", SHARDED_SCHEMES)
def test_sharded_decode_on_card(cuda, scheme):
    """Four shards on one card: each launches the scheme's kernel once and
    the whole decode equals the single-GPU one and the oracle."""
    from giddy_tpu_torch import dist
    from giddy_tpu_torch.datagen import gen_column

    col = gtt.encode(gen_column(scheme, 7 * GROUP + 99, rng_of(f"cuda/dist/{scheme}")), scheme)
    gtt.decode(col, device=cuda)
    torch.cuda.synchronize()
    kernels.reset_launches()
    gtt.decode(col, device=cuda)
    single = {k: c for k, c in kernels.launches().items() if c}
    mesh = dist.Mesh([cuda] * 4)
    kernels.reset_launches()
    got = dist.decode_sharded(col, mesh)
    launched = {k: c for k, c in kernels.launches().items() if c}
    assert sum(launched.values()) == 4 * sum(single.values())
    if scheme != "dzbv":  # a slice of dzbv may take another stream form than the whole column's prep
        assert launched == {k: 4 * c for k, c in single.items()}
    assert got.device.type == "cuda" and np.array_equal(got.cpu().numpy().view(np.uint8),
                                                        gtt.decode_ref(col).view(np.uint8))


def test_sharded_scans_on_card(cuda):
    from giddy_tpu_torch import dist, dist_query, groupby
    from giddy_tpu_torch.datagen import gen_column

    mesh = dist.Mesh([cuda] * 4)
    v = gen_column("nbit", 9 * GROUP + 5, rng_of("cuda/dist/scans"))
    col = gtt.encode(v, "nbit")
    med = int(np.median(v))
    kernels.reset_launches()
    assert dist_query.count_where_sharded(col, "lt", med, mesh) == int((v < med).sum())
    assert kernels.launches()["filter_fold"] == 4
    words = dist_query.filter_bitmap_sharded(col, "lt", med, mesh)
    assert torch.equal(words, query._mask_pad(query.filter_bitmap(col, "lt", med, device=cuda), col.n))
    kernels.reset_launches()
    assert dist_query.sum_sharded(col, mesh) == int(v.astype(np.int64).sum())
    assert dist_query.min_sharded(col, mesh) == int(v.min()) and dist_query.max_sharded(col, mesh) == int(v.max())
    assert kernels.launches()["agg_fold"] == 12
    vocab = np.arange(12, dtype=np.int32) * 5 - 20
    keys = gtt.encode(vocab[rng_of("cuda/dist/keys").integers(0, 12, v.size)], "cascade")
    r, w = dist_query.group_reduce_sharded(keys, col, ("count", "sum", "min", "max"), mesh=mesh), \
        groupby.group_reduce(keys, col, ("count", "sum", "min", "max"), device=cuda)
    assert all(np.array_equal(getattr(r, f), getattr(w, f)) for f in ("keys", "count", "sum", "min", "max"))


# -- the SASS census (roofline.ops_audit, roofline.kernel_census) ---------------
# The tiers of tests/test_ops_roofline.py, for Hopper. Every core scheme's
# census at 8 * GROUP is closed (no unknown opcode, every loop declared).
# Those under their budget in every pipe are memory-bound. The others have a
# documented cap about 20% above the census the card gave (NVIDIA H100 80GB
# HBM3, 700.00 W), on issue and on the ALU pipe, which is the one they pass:
# - delta: the block-row scan a slot (a 5-step shuffle scan, two warp
#   reductions, a barrier) for 2-3 bytes read;
# - xordelta: the same scan with XOR, against a budget of 62 a value;
# - alp: two lane unpacks (values and corrections), the float convert and
#   multiply, and the exception phase.
OPS_MEMORY_BOUND = ("nbit", "for", "delta2", "dict", "rle", "rpe", "model", "bitmap", "dzbf", "dzbv", "patched",
                    "raw", "cascade")
OPS_CAPS = {"delta": (79.0, 41.7), "xordelta": (74.3, 45.3), "alp": (68.5, 40.9)}  # (issue, alu) a value


def _ops_column(scheme):
    from giddy_tpu_torch.datagen import gen_column

    return gtt.encode(gen_column(scheme, 8 * GROUP, rng_of(f"cuda/ops/{scheme}")), scheme)


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_ops_census_is_closed(cuda, scheme):
    from giddy_tpu_torch import roofline

    a = roofline.ops_audit(_ops_column(scheme), cuda)
    assert a["interpreted"] is False and a["unknown_per_elem"] == 0 and not a["loops_mismatch"], a
    assert (a["kernels"] == []) == (scheme == "raw")
    assert all(a[f"floor_{p}_per_elem"] <= a[f"{p}_per_elem"] for p in roofline.PER_SM_CLOCK)


@pytest.mark.parametrize("scheme", OPS_MEMORY_BOUND)
def test_ops_memory_bound(cuda, scheme):
    from giddy_tpu_torch import roofline

    a = roofline.ops_audit(_ops_column(scheme), cuda)
    assert a["memory_bound"] and a["issue_headroom"] >= 1, {k: a[k] for k in ("issue_per_elem", "budget")}


@pytest.mark.parametrize("scheme", sorted(OPS_CAPS))
def test_ops_caps(cuda, scheme):
    from giddy_tpu_torch import roofline

    a = roofline.ops_audit(_ops_column(scheme), cuda)
    issue, alu = OPS_CAPS[scheme]
    assert not a["memory_bound"] and a["issue_per_elem"] <= issue and a["alu_per_elem"] <= alu, a


def test_ops_tiers_cover_all_schemes():
    assert set(OPS_MEMORY_BOUND) | set(OPS_CAPS) == set(CORE_SCHEMES)
    assert not set(OPS_MEMORY_BOUND) & set(OPS_CAPS)


def test_card_rates_table(cuda):
    from giddy_tpu_torch import roofline

    name = torch.cuda.get_device_name(cuda)
    assert torch.cuda.get_device_properties(cuda).multi_processor_count == roofline.SM_CLOCK[name][0]
    assert roofline.chip_rates()["issue"] == 128 * roofline.SM_CLOCK[name][0] * roofline.SM_CLOCK[name][1]


def _closed(name, args, values):
    from giddy_tpu_torch import roofline

    c = roofline.kernel_census(name, args, values)
    assert c["unknown_per_elem"] == 0 and not c["loops_mismatch"], (name, c["kernels"], c["loops"])
    return c


@pytest.mark.parametrize("dtype", ["int32", "int16", "uint8"])
@pytest.mark.parametrize("scheme", ["nbit", "for", "delta", "dict", "rle", "delta2", "patched", "model", "bitmap"])
def test_ops_census_of_every_store_type(cuda, scheme, dtype):
    """Each kernel's instance for each store type T, and K5 in each form."""
    v = _values(scheme if scheme not in ("patched", "model", "bitmap") else "nbit", dtype, rng_of(f"ops/{scheme}"))
    if scheme == "bitmap":
        v = v % 5
    col = gtt.encode(v, scheme)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), gtt.narrow_store_dtype(col))
    c = _closed(name, args, 4 * GROUP)
    assert _wrap.T_NAME[gtt.narrow_store_dtype(col)] in c["kernels"][0]


@pytest.mark.parametrize("density", ["long", "mid", "single"])
def test_ops_census_of_run_expand_forms(cuda, density):
    col = gtt.encode(_run_values(density, rng_of(f"ops/rle/{density}")), "rle")
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    assert name == "run_expand"
    _closed(name, args, 4 * GROUP)


@pytest.mark.parametrize("d", [8, 1000, 65536])
@pytest.mark.parametrize("inner", ["rle", "rpe", "delta", "delta2", "nbit", "for", "raw"])
def test_ops_census_of_cascade_tables(cuda, inner, d):
    """The LUT stage in shared memory (and its copy loop) and from global
    memory, for each inner kernel."""
    v, vocab = _cascade_values(d, np.random.default_rng(d))
    col = gtt.encode(v, "cascade", codes_scheme=inner, dictionary=vocab)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, cuda), torch.int32)
    _closed("cascade_lut", (name, args), 4 * GROUP)


@pytest.mark.parametrize("form", ["tile", "group", "plane"])
@pytest.mark.parametrize("kind", ["one_byte", "two_bytes", "mixed", "full"])
def test_ops_census_of_dzbv_forms(cuda, form, kind):
    """K13, K14 and K15 (with its count kernel) at each highest plane."""
    col = gtt.encode(dzbv_values(kind, 3 * GROUP + 17, rng_of(f"ops/dzbv/{kind}")).view(np.int32), "dzbv")
    streams = dzbv.form_streams(col, form)
    name, args = kernels.kernel_call(col, gtt.upload(streams, cuda), torch.int32)
    c = _closed(name, args, 4 * GROUP)
    assert len(c["kernels"]) == (2 if name == "dzbv_plane_decode" else 1)


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("kind,itemsize", [("u", 4), ("u", 1), ("i", 4), ("i", 2), ("i", 1), ("f", 4)])
def test_ops_census_of_scan_folds(cuda, kind, itemsize, nullable):
    """K16 and K17 in every kind, with the narrow copy of a signed kind,
    with and without validity words, on more tiles than the grid has
    blocks."""
    ng = torch.cuda.get_device_properties(cuda).multi_processor_count + 3
    bits = 8 * itemsize - 1
    packed = _words(rng_of(f"ops/fold/{kind}/{itemsize}"), (ng, bits * LANES), cuda)
    valid = _words(rng_of("ops/fold/valid"), (ng, LANES), cuda) if nullable else None
    for op in ("lt", "eq"):
        _closed("filter_fold", (packed, None, valid, bits, kind, itemsize, op, 3), ng * GROUP)
    for name in ("sum",) if nullable else ("sum", "min", "max"):
        _closed("agg_fold", (packed, None, valid, bits, ng * GROUP - 5, kind, itemsize, name), ng * GROUP)


@pytest.mark.parametrize("tiles", [1, 4, 32, 64])
def test_ops_census_of_run_filter(cuda, tiles):
    """K19 in every kind, at two ops, with and without validity words, at
    the smallest and the largest w_pad."""
    ng = 3
    valid = _words(rng_of("ops/k19/valid"), (ng, LANES), cuda)
    for w_pad in (8, 128):
        ends, vals = run_tables("random", w_pad, tiles, ng)
        e, u = torch.from_numpy(ends).to(cuda), torch.from_numpy(vals).to(cuda)
        for kind, itemsize in (("u", 4), ("i", 2), ("f", 4)):
            for op in ("lt", "eq"):
                for vw in (None, valid):
                    _closed("run_filter", (e, u, vw, ng, kind, itemsize, op, 3), ng * GROUP)


@pytest.mark.parametrize("prologue", ["none", "for_sub", "delta_zigzag"])
def test_ops_census_of_lmp_pack(cuda, prologue):
    """K18 at every width B = 1..32 and each prologue."""
    values = _words(rng_of("ops/pack"), (2, GROUP), cuda)
    refs = torch.zeros(2, dtype=torch.int32, device=cuda) if prologue == "for_sub" else None
    for bits in range(1, 33):
        _closed("lmp_pack", (values, bits, prologue, refs), 2 * GROUP)
