"""giddy_tpu_torch's host layer against giddy_tpu's: encode, containers,
oracle decode and the NumPy utilities must agree byte for byte."""

import hashlib
import pathlib

import numpy as np
import pytest

import giddy_tpu as gt
import giddy_tpu.datagen as gt_datagen
import giddy_tpu.util as gt_util
import giddy_tpu_torch as gtt
import giddy_tpu_torch.datagen as port_datagen
import giddy_tpu_torch.util as port_util
from giddy_tpu_torch.util import GROUP

from helpers import gen_column

from test_torch_inputs import assert_same_column

GOLDEN = pathlib.Path(__file__).parent / "golden"
SCHEMES = ["nbit", "dzbf", "for", "delta", "dict", "dzbv"]


def assert_same_streams(got: dict | None, want: dict | None):
    """Two stream dicts (a host prep's), or two Nones, byte for byte."""
    assert (got is None) == (want is None)
    if want is not None:
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
            assert got[k].tobytes() == w.tobytes(), k


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_matches_reference(scheme, hard):
    rng = np.random.default_rng(31)
    v = gen_column(scheme, 2 * GROUP + 999, rng, hard=hard)
    assert_same_column(gtt.encode(v, scheme, name="c"), gt.encode(v, scheme, name="c"))


@pytest.mark.parametrize(
    "scheme,opts",
    [("nbit", {"bits": 17}), ("dzbf", {"width": 3}), ("for", {"frame_len": 2 * GROUP}),
     ("dict", {"dictionary": np.arange(-50, 50, dtype=np.int32)})],
)
def test_encode_options_match_reference(scheme, opts):
    rng = np.random.default_rng(32)
    v = rng.integers(-50, 50, 3 * GROUP).astype(np.int32) if scheme == "dict" else (
        rng.integers(0, 40_000, 3 * GROUP).astype(np.int32))
    assert_same_column(gtt.encode(v, scheme, **opts), gt.encode(v, scheme, **opts))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "uint32", "float32"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_and_oracle_dtypes_match_reference(scheme, dtype):
    rng = np.random.default_rng(33)
    raw = rng.integers(0, 2**32, GROUP + 77, dtype=np.uint64).astype(np.uint32)
    v = raw.view(np.float32) if dtype == "float32" else raw.astype(np.dtype(dtype))
    if scheme == "dict":
        v = v[rng.integers(0, 300, v.shape[0])]
    port, ref = gtt.encode(v, scheme), gt.encode(v, scheme)
    assert_same_column(port, ref)
    out = gtt.decode_ref(port)
    assert out.dtype == v.dtype
    assert out.tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()


@pytest.mark.parametrize(
    "scheme,digest_name,gen",
    [("nbit", "nbit_9bit", None), ("dzbf", "dzbf_2b", None), ("for", "for_ts", None),
     ("delta", "delta_ts", None), ("dict", "dict_lowcard", None),
     ("delta2", "delta2_sampled", None), ("rle", "rle_flags", None), ("rpe", "rpe_flags", None),
     ("xordelta", "xordelta_sensor", None), ("patched", "patched_for", None), ("raw", "raw_rand", None),
     ("cascade", "cascade_rledict", None),
     # model_linear's input is gen_column("delta"), as in tests/test_container.py
     ("model", "model_linear", "delta"), ("model", "model_poly2", "model"),
     ("bitmap", "bitmap_4", None), ("alp", "alp_prices", None), ("dzbv", "dzbv_mixed", None)],
)
def test_golden_container_digests(scheme, digest_name, gen):
    """The port writes the checked-in golden containers of
    tests/test_container.py byte for byte (all 17)."""
    rng = np.random.default_rng(20260817)
    v = gen_column(gen or scheme, GROUP + 100, rng)
    col = gtt.encode(v, scheme, name=digest_name)
    digest = hashlib.sha256(gtt.container_bytes([col])).hexdigest()
    assert (GOLDEN / f"{digest_name}.sha256").read_text().strip() == digest


@pytest.fixture(scope="module")
def columns():
    """(values, reference column) per scheme, small and ragged."""
    rng = np.random.default_rng(34)
    out = {}
    for s in SCHEMES:
        v = gen_column(s, GROUP + 5, rng)
        out[s] = (v, gt.encode(v, s, name=f"c_{s}"))
    return out


def test_containers_round_trip_both_ways(columns, tmp_path):
    refs = [col for _, col in columns.values()]
    blob = gt.container_bytes(refs)
    ported = gtt.read_container(blob)
    assert gtt.container_bytes(ported) == blob
    for p, r in zip(ported, refs):
        assert_same_column(p, r)
        assert gtt.decode_ref(p).tobytes() == gt.decode_ref(r).tobytes()
    back = gt.read_container(gtt.container_bytes(ported))
    for b, r in zip(back, refs):
        assert b.params == r.params
        np.testing.assert_array_equal(gt.decode_ref(b), gt.decode_ref(r))
    path = tmp_path / "cols.gtp"
    path.write_bytes(blob)
    for p, (v, _) in zip(gtt.open_container(str(path)), columns.values()):
        np.testing.assert_array_equal(gtt.decode_ref(p), v)


def test_from_reference(columns):
    for v, ref in columns.values():
        port = gtt.from_reference(ref)
        assert isinstance(port, gtt.EncodedColumn)
        assert_same_column(port, ref)
        assert port.static_key() == ref.static_key()
        np.testing.assert_array_equal(gtt.decode_ref(port), v)
        np.testing.assert_array_equal(gtt.decode(port, device="cpu").numpy(), v)


def test_container_rejects_corruption():
    blob = gtt.container_bytes([gtt.encode(np.arange(100, dtype=np.int32), "nbit")])
    with pytest.raises(ValueError, match="truncated"):
        gtt.read_container(blob[:10])
    with pytest.raises(ValueError, match="magic"):
        gtt.read_container(b"NOTGIDDY" + blob[8:])
    with pytest.raises(ValueError, match="exceeds"):
        gtt.read_container(blob[:-64])


def test_util_matches_reference():
    rng = np.random.default_rng(35)
    d = rng.integers(-(2**31), 2**31, 5000, dtype=np.int64).astype(np.int32)
    z = port_util.zigzag(d)
    np.testing.assert_array_equal(z, gt_util.zigzag(d))
    np.testing.assert_array_equal(port_util.unzigzag(z), gt_util.unzigzag(z))
    np.testing.assert_array_equal(port_util.unzigzag(z), d)
    v = rng.integers(-5, 5, 1000).astype(np.int32)
    for a, b in zip(port_util.sorted_factorize(v), gt_util.sorted_factorize(v)):
        np.testing.assert_array_equal(a, b)
    for x in (0, 1, 255, 256, 2**31 - 1, 2**32 - 1):
        assert port_util.bits_needed(x) == gt_util.bits_needed(x)
        assert port_util.bytes_needed(x) == gt_util.bytes_needed(x)
    for n in (0, 1, GROUP, GROUP + 1):
        assert port_util.num_groups(n) == gt_util.num_groups(n)
    assert (port_util.LANES, port_util.SLOTS, port_util.GROUP) == (gt_util.LANES, gt_util.SLOTS, gt_util.GROUP)


@pytest.mark.parametrize("n", [0, 1000, GROUP + 7])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("scheme", gt_datagen.CORE_SCHEMES + ["wide"])
def test_datagen_matches_reference(scheme, hard, n):
    """The port's gen_column gives the reference's bytes from the same seed."""
    got = port_datagen.gen_column(scheme, n, np.random.default_rng(37), hard=hard)
    want = gt_datagen.gen_column(scheme, n, np.random.default_rng(37), hard=hard)
    assert got.dtype == want.dtype and got.shape == want.shape == (n,)
    assert got.tobytes() == want.tobytes()


def test_datagen_scheme_list_matches_reference():
    assert port_datagen.CORE_SCHEMES == gt_datagen.CORE_SCHEMES
    with pytest.raises(ValueError):
        port_datagen.gen_column("no_such_scheme", 10, np.random.default_rng(0))


@pytest.mark.parametrize("frame_groups", [1, 2, 3])
def test_for_prep_matches_reference(frame_groups):
    from giddy_tpu.kernels import for_ as gt_for
    from giddy_tpu_torch.kernels import for_ as port_for

    rng = np.random.default_rng(36)
    v = gen_column("for", 4 * GROUP + 3, rng)
    ref = gt.encode(v, "for", frame_len=frame_groups * GROUP)
    want = gt_for.prep(ref)
    got = port_for.prep(gtt.from_reference(ref))
    np.testing.assert_array_equal(got["refs_g"], want["refs_g"].reshape(-1))
    assert got["refs_g"].dtype == np.int32
    np.testing.assert_array_equal(got["packed"], want["packed"])


@pytest.mark.parametrize("kind,n", [
    ("mixed", 100), ("mixed", GROUP), ("mixed", 3 * GROUP + 17), ("mixed", 8 * GROUP), ("skewed", 8 * GROUP),
    ("skewed", 3 * GROUP + 17), ("group_skewed", 3 * GROUP + 17), ("one_byte", GROUP + 3),
    ("two_bytes", 2 * GROUP), ("per_tile", 2 * GROUP + 5), ("full", GROUP),
])
def test_dzbv_prep_matches_reference(kind, n):
    """dzbv's host prep, byte for byte against giddy_tpu.kernels.dzbv at its
    constants: tile_prep and group_prep (the cap's verdict included, and
    forced), the prep's choice, and the slice-stable stride and row-width
    choosers on the column's counts."""
    from giddy_tpu.kernels import dzbv as gt_dzbv
    from giddy_tpu_torch.kernels import dzbv as port_dzbv

    from test_torch_inputs import dzbv_values, rng_of

    v = dzbv_values(kind, n, rng_of(f"prep-{kind}-{n}"), per_tile=40)
    ref = gt.encode(v.view(np.int32), "dzbv")
    col = gtt.from_reference(ref)
    assert_same_streams(port_dzbv.tile_prep(col), gt_dzbv.tile_prep(ref))
    assert_same_streams(port_dzbv.group_prep(col), gt_dzbv.group_prep(ref))
    assert_same_streams(port_dzbv.prep(col), gt_dzbv._prep(ref))
    tiles = port_dzbv.form_streams(col, "tile")
    strides = {int(k[-1]): t.shape[1] // 64 for k, t in tiles.items() if k.startswith("trow")}
    assert_same_streams(tiles, gt_dzbv.tile_prep(ref, force_s=strides))
    rows = port_dzbv.form_streams(col, "group")
    w4s = {int(k[-1]): t.shape[1] // 1024 for k, t in rows.items() if k.startswith("prow")}
    assert_same_streams(rows, gt_dzbv.group_prep(ref, force_w4=w4s))
    w = (v.astype(np.int64) > np.array([[0xFF], [0xFFFF], [0xFFFFFF]]))
    pad = -n % GROUP
    w = np.pad(w, ((0, 0), (0, pad)))
    tile_counts = {k: w[k - 1].reshape(-1, 128).sum(axis=1) for k in (1, 2, 3)}
    group_counts = {k: w[k - 1].reshape(-1, GROUP).sum(axis=1) for k in (1, 2, 3)}
    for ragged in (False, True):
        assert port_dzbv.global_tile_s(tile_counts, ragged=ragged) == gt_dzbv.global_tile_s(tile_counts, ragged=ragged)
    assert port_dzbv.global_w4(group_counts) == gt_dzbv.global_w4(group_counts)


def test_dzbv_choose_strides_matches_reference():
    from giddy_tpu.kernels import dzbv as gt_dzbv
    from giddy_tpu_torch.kernels import dzbv as port_dzbv

    rng = np.random.default_rng(38)
    for _ in range(300):
        planes = sorted(rng.choice([1, 2, 3], rng.integers(1, 4), replace=False).tolist())
        max_cnts = {k: int(rng.integers(0, 129)) for k in planes}
        means = {k: float(rng.uniform(0, max_cnts[k] / 128)) for k in planes} if rng.random() < 0.8 else None
        assert port_dzbv.choose_strides(max_cnts, means) == gt_dzbv.choose_strides(max_cnts, means)
    for s in range(8, 129, 8):
        assert port_dzbv._straddle_frac(s) == gt_dzbv._straddle_frac(s)
        assert port_dzbv._stride_for(s - 3) == gt_dzbv._stride_for(s - 3)
    assert (port_dzbv.PAD_CAP, port_dzbv.TILE, port_dzbv.STRIDE_Q, port_dzbv._KAPPA) == (
        gt_dzbv.PAD_CAP, gt_dzbv.TILE, gt_dzbv.STRIDE_Q, gt_dzbv._KAPPA)
