"""giddy_tpu_torch's bitmap scheme against giddy_tpu's, on the CPU: encode
and decode through K11's plain version against the JAX decode (Pallas
interpret mode up to d = 64, its XLA loop above), the NumPy oracle and the
input. Everything is compared bit for bit (tolerance 0)."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import bitmap, lanes
from giddy_tpu_torch.util import GROUP, LANES

from test_torch_host import assert_same_column
from test_torch_inputs import JAX, bitmap_values, rng_of

N = 2 * GROUP + 999  # three groups, the last one ragged


# The JAX decodes run in the worker's reference process (test_torch_inputs.JAX),
# so that the xdist worker keeps none of their interpret-mode programs.


def jax_decode(ref, **kw) -> np.ndarray:
    return np.asarray(gt.decode(ref, **kw))


def values(d: int, n: int, seed: str, dtype: str = "int32") -> np.ndarray:
    return bitmap_values(d, n, rng_of(seed), dtype)


def _decode_both(ref, **kw):
    out = gtt.decode(gtt.from_reference(ref), device="cpu", **kw)
    return out, JAX(jax_decode, ref, **kw)


def check_all(v: np.ndarray) -> gtt.EncodedColumn:
    port, ref = gtt.encode(v, "bitmap", name="b"), gt.encode(v, "bitmap", name="b")
    assert_same_column(port, ref)
    assert gtt.decode_ref(port).tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()
    got, want = _decode_both(ref, pad=True)
    assert got.shape == (max(1, -(-v.shape[0] // GROUP)) * GROUP,)
    assert got.numpy().tobytes() == want.tobytes()
    out = gtt.decode(port, device="cpu")
    assert out.dtype == getattr(torch, str(v.dtype)) and out.numpy().tobytes() == v.tobytes()
    return port


# d = 65 is past the reference's switch to an XLA loop (its compile takes
# most of this file's time, so it runs at one size)
@pytest.mark.parametrize("d,n", [(1, N), (4, N), (12, N), (65, N), (1, GROUP), (4, GROUP), (4, 0)])
def test_bitmap_matches_jax_oracle_and_input(d, n):
    col = check_all(values(d, n, f"{d}{n}"))
    assert col.params["d"] == (d if n else 0)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16"])
def test_narrow_stores(dtype):
    col = check_all(values(12, N, dtype, dtype))
    assert gtt.narrow_store_dtype(col) == (torch.uint8 if dtype.endswith("int8") else torch.int16)


def test_pad_code_is_value_zero():
    """Pad positions take value 0's bitmap when 0 is a value, else bitmap 0."""
    v = values(5, N, "zero")
    v[::7] = 0
    col = check_all(v)
    out = gtt.decode(col, device="cpu", pad=True).numpy()
    assert 0 in col.streams["values"] and not out[N:].any()
    check_all(np.full(N, 9, np.int32))


def test_two_incident_bits_sum():
    """A malformed column with two bits set at one position: the port sums
    (as the reference's kernel and oracle do), it does not select."""
    v = values(4, N, "malformed")
    ref = gt.encode(v, "bitmap")
    bm = ref.streams["bitmaps"].copy()
    bm[1] |= bm[0]  # every position of value 0 is now also incident to value 1
    ref.streams["bitmaps"] = bm
    got, want = _decode_both(ref, pad=True)
    assert got.numpy().tobytes() == want.tobytes()
    vals = ref.streams["values"].astype(np.int64)
    expect = np.where(v == vals[0], vals[0] + vals[1], v).astype(np.uint32).view(np.int32)
    assert got.numpy()[:N].tobytes() == expect.tobytes() == gt.decode_ref(ref).tobytes()


def test_kernel_call_and_cpu_launches_nothing():
    v = values(4, N, "call", "int16")
    col = gtt.encode(v, "bitmap")
    before = kernels.launches()
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), gtt.narrow_store_dtype(col))
    bitmaps, vals, ng, out_dtype = args
    assert name == "bitmap_decode" and bitmaps.shape == (4, 3 * LANES) and vals.shape == (4,)
    assert ng == 3 and out_dtype == torch.int16
    out = bitmap.bitmap_decode(*args)
    assert kernels.launches() == before
    assert torch.equal(out, lanes.bitmap_decode(*args))
    assert out.reshape(-1)[:N].numpy().tobytes() == v.tobytes()


def test_empty_column_launches_nothing():
    """d = 0: no planes; the padded output is zeros, as the reference's."""
    ref = gt.encode(np.zeros(0, np.int8), "bitmap")
    assert ref.params["d"] == 0
    got, want = _decode_both(ref, pad=True)
    assert got.shape == (GROUP,) and got.dtype == torch.int8 and not got.any()
    assert got.numpy().tobytes() == want.astype(np.int8).tobytes()


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: bitmap.bitmap_decode(torch.zeros((2, 2048), dtype=torch.int32), torch.zeros(3, dtype=torch.int32), 2),
         ValueError),
        (lambda: bitmap.bitmap_decode(torch.zeros((2, 2048), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 3),
         ValueError),
        (lambda: bitmap.bitmap_decode(torch.zeros((2, 2048), dtype=torch.int64), torch.zeros(2, dtype=torch.int32), 2),
         TypeError),
        (lambda: bitmap.bitmap_decode(torch.zeros(2048, dtype=torch.int32), torch.zeros(1, dtype=torch.int32), 2),
         ValueError),
        (lambda: bitmap.bitmap_decode(torch.zeros((0, 2048), dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 2),
         ValueError),
        (lambda: bitmap.bitmap_decode(torch.zeros((2, 2048), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 0),
         ValueError),
        (lambda: bitmap.bitmap_decode(torch.zeros((2, 2048), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 2,
                                      torch.float32), TypeError),
    ],
)
def test_wrapper_rejects_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()
