"""giddy_tpu_torch.stream against giddy_tpu.stream on the CPU, tolerance 0:
the same numpy-seeded columns stream in chunks of 2 groups at n =
2·GROUP + 999 (a whole chunk, then a ragged one-group chunk), and every
chunk (dtype, length, bytes) and every ``stream_count_where`` count must
equal the reference's: plain schemes, wide (NumPy chunks), patched and alp
(the slicer's exception scatter), dzbv, dict and cascade (the dictionary
pushdown on device-form streams) and nullable columns, n = 0 too. The
reference streams through its Pallas decoders in interpret mode in the
worker's reference process, each column once per run
(test_torch_inputs.ReferenceParts), so that no worker keeps any of its
programs; the remaining schemes and a larger column are
held against the port's NumPy oracle and query.count_where."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu_torch import query, stream
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import ReferenceParts, rng_of, wide_values

N = 2 * GROUP + 999
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pair(kind: str, n: int = N):
    """(values, reference column, port column) of ``kind``: a datagen
    scheme name, "wide", "nullable-<scheme>" (10% nulls) or "cascade-for"."""
    rng = rng_of(f"stream/{kind}/{n}")
    valid = None
    scheme, opts = kind, {}
    if kind.startswith("nullable-"):
        scheme = kind.split("-", 1)[1]
        valid = rng.random(n) > 0.1
    if kind == "cascade-for":
        scheme, opts = "cascade", {"codes_scheme": "for"}
    if kind == "wide":
        v = wide_values("orderkey", n, rng)
        ref = gt.encode(v, "wide", base_scheme="delta", hi_scheme="nbit")
    else:
        v = gen_column("cascade" if scheme == "cascade" else scheme, n, rng)
        ref = gt.encode(v, scheme, valid=valid, **opts)
    return v, ref, gtt.from_reference(ref)


def same_chunks(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


JAX_KINDS = ["nbit", "for", "rle", "patched", "alp", "dzbv", "dict", "cascade-for", "wide", "nullable-nbit",
             "nullable-dict"]


def reference_part(kind: str) -> dict:
    """giddy_tpu.stream's chunks and count of a JAX_KINDS column, or of the
    empty one (run in the worker's reference process). dzbv's filter in interpret
    mode is the slowest trace of all: its count is held to the port's
    count_where instead, whose bitmaps equal the reference's
    (test_torch_query.py)."""
    from giddy_tpu import stream as jstream

    if kind == "empty":
        ref = gt.encode(np.zeros(0, np.int32), "nbit")
        return {"chunks": [np.asarray(c) for c in jstream.stream_decode(ref, to_host=True)],
                "ge": jstream.stream_count_where(ref, "ge", 0)}
    v, ref, _ = pair(kind)
    out = {"chunks": [np.asarray(c) for c in jstream.stream_decode(ref, chunk_groups=2, to_host=True)]}
    if kind != "dzbv":
        out["lt"] = jstream.stream_count_where(ref, "lt", v[N // 2].item(), chunk_groups=2)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """ref(kind): the reference's chunks and count of that column,
    computed once per run."""
    return ReferenceParts(tmp_path_factory, "stream", reference_part)


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_chunks_and_counts_match_the_reference(ref, kind):
    v, _, col = pair(kind)
    want = ref(kind)
    got = list(stream.stream_decode(col, chunk_groups=2, to_host=True, device=CPU))
    same_chunks(got, want["chunks"])
    assert [c.shape[0] for c in got] == [2 * GROUP, 999]
    if kind != "wide":  # device chunks are tensors on the device, wide ones NumPy
        assert all(isinstance(c, torch.Tensor) for c in stream.stream_decode(col, chunk_groups=2, device=CPU))
    pivot = v[N // 2].item()
    got = stream.stream_count_where(col, "lt", pivot, chunk_groups=2, device=CPU)
    assert got == (query.count_where(col, "lt", pivot, device=CPU) if kind == "dzbv" else want["lt"])
    assert stream.stream_count_where(col, "eq", pivot, chunk_groups=2, device=CPU) == \
        query.count_where(col, "eq", pivot, device=CPU)


@pytest.mark.parametrize("scheme", ["dzbf", "delta", "delta2", "xordelta", "rpe", "model", "bitmap", "raw",
                                    "cascade"])
def test_other_schemes_stream_as_the_oracle(scheme):
    v, _, col = pair(scheme)
    for cg in (1, 2, 5):
        out = stream.decode_streamed(col, chunk_groups=cg, device=CPU)
        assert out.dtype == v.dtype and out.tobytes() == gtt.decode_ref(col).tobytes()
    pivot = v[N // 3].item()
    for op in ("lt", "ge", "ne"):
        assert stream.stream_count_where(col, op, pivot, chunk_groups=2, device=CPU) == \
            query.count_where(col, op, pivot, device=CPU)


def test_empty_column_streams_one_empty_chunk(ref):
    col, want = gtt.from_reference(gt.encode(np.zeros(0, np.int32), "nbit")), ref("empty")
    same_chunks(list(stream.stream_decode(col, to_host=True, device=CPU)), want["chunks"])
    assert stream.stream_count_where(col, "ge", 0, device=CPU) == want["ge"] == 0


def test_out_of_range_values_stage_as_count_where():
    """Integer values past int32 wrap mod 2^32 in the device compare; the
    patched chunks' host compare and the device chunks agree with
    count_where (the reference's regression test, on the port)."""
    v, _, col = pair("patched")
    nb = gtt.encode(v, "nbit")
    for value in (int(np.median(v)), 2**31 + 5, -(2**31) - 3):
        for c in (col, nb):
            assert stream.stream_count_where(c, "lt", value, chunk_groups=2, device=CPU) == \
                query.count_where(c, "lt", value, device=CPU)


def test_larger_column_bounded_window(monkeypatch):
    """23 groups in chunks of 4 (a ragged last chunk of 2 groups and a few
    rows), float32 with NaN/-0.0 salted in: chunks equal the column, counts
    equal count_where, and the stream never runs more than DECODE_DEPTH
    decodes ahead of the consumer."""
    from giddy_tpu_torch import api

    rng = rng_of("stream/large")
    n = 22 * GROUP + 77
    v = rng.normal(0, 10, n).astype(np.float32)
    v[rng.integers(0, n, 50)] = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)[rng.integers(0, 5, 50)]
    col = gtt.encode(v, "raw")
    decoded = []
    real = api.get_decoder

    def counting(c, *a, **kw):
        fn = real(c, *a, **kw)
        return lambda streams: decoded.append(c.n) or fn(streams)

    monkeypatch.setattr(api, "get_decoder", counting)
    chunks = []
    for chunk in stream.stream_decode(col, chunk_groups=4, device=CPU):
        assert len(decoded) - len(chunks) <= stream.DECODE_DEPTH + 1
        chunks.append(chunk)
    assert [c.shape[0] for c in chunks] == [4 * GROUP] * 5 + [2 * GROUP + 77] == decoded
    assert np.concatenate([c.numpy() for c in chunks]).tobytes() == v.tobytes()
    for value in (-1.5, 0.0, -0.0, float("nan")):
        assert stream.stream_count_where(col, "lt", value, chunk_groups=4, device=CPU) == \
            query.count_where(col, "lt", value, device=CPU)


def test_bad_op_and_missing_card():
    _, _, col = pair("nbit")
    with pytest.raises(ValueError, match="op must be"):
        stream.stream_count_where(col, "between", 1, device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the missing-card error cannot occur")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(stream.stream_decode(col))
