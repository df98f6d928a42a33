"""giddy_tpu_torch.decode_columns against giddy_tpu.decode_columns on the
CPU: the mixed container of BASELINE configs[4] as bench.py's bench_mixed
builds it (delta, dict, rle, patched from one default_rng(0)), at 2^16
values a column, plus a cascade and a raw column. Every column is compared
bit for bit (tolerance 0)."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu_torch import api
from giddy_tpu_torch.datagen import gen_column

N = 2**16
MIX = ("delta", "dict", "rle", "patched")


@pytest.fixture(scope="module")
def container():
    """(values, reference column) of bench_mixed's four schemes, then a
    cascade and a raw column."""
    rng = np.random.default_rng(0)
    out = []
    for s in (*MIX, "cascade", "raw"):
        v = gen_column(s, N, rng)
        out.append((v, gt.encode(v, s, name=f"mix_{s}")))
    return out


def test_matches_jax_decode_columns(container):
    refs = [ref for _, ref in container]
    got = gtt.decode_columns([gtt.from_reference(r) for r in refs], device="cpu")
    want = gt.decode_columns(refs)
    assert list(got) == list(want) == [r.name for r in refs]
    for v, ref in container:
        out = got[ref.name]
        assert out.device.type == "cpu" and out.dtype == torch.int32 and out.shape == (N,)
        assert out.numpy().tobytes() == np.asarray(want[ref.name]).tobytes() == v.tobytes()


def test_pad_matches_jax(container):
    refs = [ref for _, ref in container]
    got = gtt.decode_columns([gtt.from_reference(r) for r in refs], device="cpu", pad=True)
    want = gt.decode_columns(refs, pad=True)
    for r in refs:
        assert got[r.name].shape == (2 * 32768,)
        assert got[r.name].numpy().tobytes() == np.asarray(want[r.name]).tobytes()


def test_later_column_of_a_name_wins(container):
    (v0, first), (v1, second) = container[0], container[1]
    dup = [gtt.from_reference(first), gtt.from_reference(second)]
    dup[1].name = dup[0].name
    got = gtt.decode_columns(dup, device="cpu")
    assert list(got) == [first.name]
    assert got[first.name].numpy().tobytes() == v1.tobytes()


def test_bench_mixed_columns_and_cached_decoders(container):
    """datagen gives the reference's columns, and the container reuses the
    decoders that single-column decode caches."""
    rng = np.random.default_rng(0)
    for s, (v, ref) in zip(MIX, container):
        port = gtt.encode(gen_column(s, N, rng), s, name=ref.name)
        assert port.static_key() == ref.static_key()
        assert gtt.decode_ref(port).tobytes() == v.tobytes()
    cols = [gtt.from_reference(r) for _, r in container]
    gtt.decode_columns(cols, device="cpu")
    size = len(api._DECODER_CACHE)
    gtt.decode_columns(cols, device="cpu")
    assert len(api._DECODER_CACHE) == size
    assert all(gtt.get_decoder(c, gtt.narrow_store_dtype(c)) is api._DECODER_CACHE[
        (c.static_key(), gtt.narrow_store_dtype(c))] for c in cols)


def test_mixed_dtypes_and_empty_columns():
    rng = np.random.default_rng(3)
    cols, values = [], {}
    for s, dtype, n in [("patched", "int16", 1000), ("cascade", "uint8", N), ("raw", "float32", 7), ("dict", "int32", 0)]:
        v = gen_column(s, n, rng).astype(np.dtype(dtype)) if dtype != "float32" else (
            gen_column(s, n, rng).view(np.float32))
        values[f"c_{s}"] = v
        cols.append(gt.encode(v, s, name=f"c_{s}"))
    got = gtt.decode_columns([gtt.from_reference(c) for c in cols], device="cpu")
    want = gt.decode_columns(cols)
    for name, v in values.items():
        assert got[name].dtype == getattr(torch, str(v.dtype))
        assert got[name].numpy().tobytes() == np.asarray(want[name]).tobytes() == v.tobytes()


def test_model_bitmap_alp_container_matches_jax():
    """The three epilogue schemes (K10-K12's plain versions) in one
    container: datagen's model (poly2), bitmap (d = 4) and alp prices."""
    rng = np.random.default_rng(10)
    cols, values = [], {}
    for s in ("model", "bitmap", "alp"):
        values[f"c_{s}"] = v = gen_column(s, N + 77, rng)
        cols.append(gt.encode(v, s, name=f"c_{s}"))
    assert cols[0].params["kind"] == "poly2" and cols[1].params["d"] == 4
    got = gtt.decode_columns([gtt.from_reference(c) for c in cols], device="cpu")
    want = gt.decode_columns(cols)
    assert list(got) == list(want) == list(values)
    for name, v in values.items():
        assert got[name].dtype == getattr(torch, str(v.dtype))
        assert got[name].numpy().tobytes() == np.asarray(want[name]).tobytes() == v.tobytes()


def test_device_argument():
    cols = [gtt.encode(np.arange(10, dtype=np.int32), "raw")]
    with pytest.raises(ValueError, match="no decoder for device"):
        gtt.decode_columns(cols, device="meta")
    if not torch.cuda.is_available():  # the card is the default: without one, no CPU fallback
        for call in (lambda: gtt.decode_columns(cols), lambda: gtt.decode_columns(cols, device="cuda")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    else:
        assert gtt.decode_columns(cols)["col"].is_cuda
    assert gtt.decode_columns([], device="cpu") == {}
