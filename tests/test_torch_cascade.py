"""giddy_tpu_torch's cascade and raw schemes against giddy_tpu's, on the CPU:
encode, the host prep, and decode through the plain versions of the inner
kernels with the dictionary stage (``lut``) against the JAX decode (Pallas
interpret mode, its fused LUT up to 2048 entries and its take above), the
NumPy oracle and the input. Everything is compared bit for bit (tolerance
0)."""

import zlib

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu.kernels import cascade as gt_cascade
from giddy_tpu.ref.cascade import INNER_SCHEMES as GT_INNER_SCHEMES
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import cascade, lanes
from giddy_tpu_torch.ref.cascade import INNER_SCHEMES
from giddy_tpu_torch.util import GROUP

from test_torch_host import assert_same_column
from test_torch_inputs import JAX

N = 2 * GROUP + 999  # three groups, the last one ragged


# The JAX decodes run in the worker's reference process (test_torch_inputs.JAX),
# so that the xdist worker keeps none of their interpret-mode programs.


def jax_decode(ref, **kw) -> np.ndarray:
    return np.asarray(gt.decode(ref, **kw))


def values(d: int, seed: str, n: int = N, run: int = 50) -> tuple[np.ndarray, np.ndarray]:
    """n values of a d-entry vocabulary in runs of ``run``, and the vocabulary."""
    rng = np.random.default_rng(zlib.crc32(seed.encode()))
    vocab = rng.permutation(np.arange(d, dtype=np.int64) * 65_537 - 2**31 + 3).astype(np.int32)
    return vocab[np.repeat(rng.integers(0, d, n // run + 1), run)[:n]], vocab


def _decode_both(ref, **kw):
    out = gtt.decode(gtt.from_reference(ref), device="cpu", **kw)
    return out, JAX(jax_decode, ref, **kw)


def assert_same_streams(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


def test_inner_schemes_match_reference():
    assert INNER_SCHEMES == GT_INNER_SCHEMES
    assert "delta2" in INNER_SCHEMES  # the code's list; FORMAT.md §1.14 omits it


@pytest.mark.parametrize("d", [1, 8, 2049, 4096])
@pytest.mark.parametrize("inner", INNER_SCHEMES)
def test_cascade_matches_jax_oracle_and_input(inner, d):
    """Every inner scheme at every dictionary size; 2049 and 4096 are past
    the reference's 2048-entry switch to an XLA take, so there the fused
    port is held to the JAX take fallback."""
    v, vocab = values(d, f"{inner}{d}")
    port = gtt.encode(v, "cascade", codes_scheme=inner, dictionary=vocab, name="c")
    ref = gt.encode(v, "cascade", codes_scheme=inner, dictionary=vocab, name="c")
    assert_same_column(port, ref)
    assert port.params["dict_size"] == d
    assert gtt.decode_ref(port).tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()
    assert_same_streams(cascade.prep(port), gt_cascade.prep(ref))
    got, want = _decode_both(ref, pad=True)
    assert got.shape == (3 * GROUP,)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy()[:N].tobytes() == v.tobytes()


@pytest.mark.parametrize("inner,dtype", [("rle", "int8"), ("rle", "float32"), ("delta", "uint16"),
                                         ("delta", "int8"), ("nbit", "float32"), ("nbit", "uint16")])
def test_narrow_and_float_stores_match_jax(inner, dtype):
    """The table is looked up on 32-bit codes and only the value is stored
    narrow (the reference's narrow LUT scratch, common.py:199-205)."""
    u = values(8, f"{inner}{dtype}")[0].view(np.uint32)
    v = u.view(np.float32) if dtype == "float32" else u.astype(np.dtype(dtype))
    ref = gt.encode(v, "cascade", codes_scheme=inner)
    assert_same_column(gtt.encode(v, "cascade", codes_scheme=inner), ref)
    col = gtt.from_reference(ref)
    store = gtt.narrow_store_dtype(col)
    assert store == {"int8": torch.uint8, "uint16": torch.int16, "float32": torch.int32}[dtype]
    got, want = _decode_both(ref, pad=True)
    assert got.dtype == getattr(torch, dtype)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy()[:N].tobytes() == v.tobytes()


@pytest.mark.parametrize("inner", ["rle", "rpe"])
def test_scatter_form_takes_the_table_after_the_scan(inner):
    """Runs of one: the inner rle/rpe reaches the scatter form, so the table
    maps K6's sums (the scattered jumps are code differences)."""
    v, vocab = values(8, inner, run=1)
    ref = gt.encode(v, "cascade", codes_scheme=inner, dictionary=vocab)
    col = gtt.from_reference(ref)
    streams = gtt.device_streams(col, "cpu")
    assert "c_pos" in streams
    name, args = kernels.kernel_call(col, streams, torch.int32)
    assert name == "cumsum_rows" and args[-1] is streams["values"]
    got, want = _decode_both(ref, pad=True)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy()[:N].tobytes() == v.tobytes()


@pytest.mark.parametrize("inner", INNER_SCHEMES)
def test_empty_column_without_dictionary(inner):
    """n = 0, d = 0: nothing to launch; the padded output is zeros, as the
    reference's pass-through codes."""
    empty = gt.encode(np.zeros(0, np.int32), "cascade", codes_scheme=inner)
    assert empty.params["dict_size"] == 0
    got, want = _decode_both(empty, pad=True)
    assert got.numpy().tobytes() == want.tobytes() and not got.any()
    assert gtt.decode(gtt.from_reference(empty), device="cpu").shape == (0,)


@pytest.mark.parametrize("inner", ["rle", "raw"])
def test_empty_column_with_dictionary(inner):
    """n = 0 with a given dictionary: the pad codes are looked up."""
    vocab = np.array([-5, 9], np.int32)
    ref = gt.encode(np.zeros(0, np.int32), "cascade", codes_scheme=inner, dictionary=vocab)
    got, want = _decode_both(ref, pad=True)
    assert got.numpy().tobytes() == want.tobytes()


def test_kernel_call_and_cpu_launches_nothing():
    v, vocab = values(8, "call")
    col = gtt.encode(v, "cascade", dictionary=vocab)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), torch.int32)
    assert name == "run_expand" and torch.equal(args[-1], torch.from_numpy(vocab))
    before = kernels.launches()
    out = cascade.cascade_lut(name, args)
    assert kernels.launches() == before
    assert out.reshape(-1)[:N].numpy().tobytes() == v.tobytes()
    assert torch.equal(out, lanes.run_expand(*args))


def test_raw_is_lmp32_word_for_word():
    """A raw ``data`` stream is an LMP(32) stream (FORMAT.md §0.1 with B =
    32), so cascade over raw decodes through K4 with 32-bit codes."""
    rng = np.random.default_rng(12)
    data = torch.from_numpy(rng.integers(-(2**31), 2**31, 3 * GROUP, dtype=np.int64).astype(np.int32))
    assert torch.equal(lanes.lmp_unpack(data.view(3, 32 * 1024), 32).reshape(-1), data)
    v, vocab = values(40, "raw")
    col = gtt.encode(v, "cascade", codes_scheme="raw", dictionary=vocab)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), torch.int32)
    assert name == "dict_decode" and args[2] == 32 and args[0].shape == (3, 32 * 1024)


@pytest.mark.parametrize("dtype", ["int32", "uint8", "int16", "float32"])
@pytest.mark.parametrize("n", [N, 0])
def test_raw_matches_jax_oracle_and_input(dtype, n):
    u = np.random.default_rng(13).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v = u.view(np.dtype(dtype)) if dtype in ("int32", "float32") else u.astype(np.dtype(dtype))
    port, ref = gtt.encode(v, "raw", name="r"), gt.encode(v, "raw", name="r")
    assert_same_column(port, ref)
    assert gtt.decode_ref(port).tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()
    got, want = _decode_both(ref, pad=True)
    assert got.numpy().tobytes() == want.tobytes()
    out = gtt.decode(port, device="cpu")
    assert out.dtype == getattr(torch, dtype) and out.numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: kernels.nbit.lmp_unpack(torch.zeros((1, 1024), dtype=torch.int32), 1,
                                         lut=torch.zeros(0, dtype=torch.int32)), ValueError),
        (lambda: kernels.for_.for_unpack(torch.zeros((1, 1024), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), 1,
                                         lut=torch.zeros(4, dtype=torch.int64)), TypeError),
        (lambda: kernels.cumsum.cumsum_rows(torch.zeros((1, GROUP), dtype=torch.int32),
                                            lut=torch.zeros((2, 2), dtype=torch.int32)), ValueError),
        (lambda: kernels.delta.delta_decode(torch.zeros((1, 1024), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), 1,
                                            lut=torch.zeros(8, dtype=torch.int32)[::2]), ValueError),
    ],
)
def test_wrappers_reject_bad_tables(call, exc):
    with pytest.raises(exc):
        call()
