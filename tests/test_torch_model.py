"""giddy_tpu_torch's model scheme against giddy_tpu's, on the CPU: encode
(linear, poly2 and the per-frame choice), the host prep, and decode through
K10's plain version against the JAX decode (Pallas interpret mode), the
NumPy oracle and the input. Everything is compared bit for bit (tolerance
0)."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu.kernels import model as gt_model
from giddy_tpu_torch import kernels
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.kernels import lanes, model
from giddy_tpu_torch.util import GROUP

from test_torch_host import assert_same_column
from test_torch_inputs import rng_of

N = 2 * GROUP + 999  # three groups, the last one ragged


def arcs(n: int, frame_len: int, seed: str) -> np.ndarray:
    """datagen's curved ramps, one a frame of frame_len."""
    return gen_column("model", n, rng_of(seed), frame_len=frame_len)


def _decode_both(ref, **kw):
    out = gtt.decode(gtt.from_reference(ref), device="cpu", **kw)
    return out, np.asarray(gt.decode(ref, **kw))


def check_all(v: np.ndarray, **opts) -> gtt.EncodedColumn:
    """encode, oracle, padded decode and decode held to the reference and
    the input; returns the port's column."""
    port, ref = gtt.encode(v, "model", name="m", **opts), gt.encode(v, "model", name="m", **opts)
    assert_same_column(port, ref)
    assert gtt.decode_ref(port).tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()
    got, want = _decode_both(ref, pad=True)
    assert got.shape == (max(1, -(-v.shape[0] // GROUP)) * GROUP,)
    assert got.numpy().tobytes() == want.tobytes()
    out = gtt.decode(port, device="cpu")
    assert out.dtype == getattr(torch, str(v.dtype)) and out.numpy().tobytes() == v.tobytes()
    return port


@pytest.mark.parametrize("n", [N, GROUP, 0])
@pytest.mark.parametrize("frame_len", [GROUP, 4 * GROUP])
@pytest.mark.parametrize("kind", ["auto", "linear", "poly2"])
def test_model_matches_jax_oracle_and_input(kind, frame_len, n):
    v = arcs(n, frame_len, f"{kind}{frame_len}{n}")
    col = check_all(v, kind=kind, frame_len=frame_len)
    if kind != "auto":
        assert col.params["kind"] == kind
    elif frame_len == GROUP and n:
        assert col.params["kind"] == "poly2"


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint16", "uint32"])
def test_narrow_and_unsigned_stores(dtype):
    v = gen_column("model", N, rng_of(dtype))
    v = v.view(np.uint32) if dtype == "uint32" else v.astype(np.dtype(dtype))
    col = check_all(v)
    assert gtt.narrow_store_dtype(col) == {"int8": torch.uint8, "int16": torch.int16, "uint16": torch.int16,
                                           "uint32": torch.int32}[dtype]


def test_hard_data_at_32_bits():
    v = gen_column("model", N, np.random.default_rng(51), hard=True)
    assert check_all(v, bits=32).params["bits"] == 32


def test_datagen_column_is_poly2():
    """The main path's column: datagen's curved ramps encode as poly2."""
    col = check_all(gen_column("model", N, np.random.default_rng(10)))
    assert col.params["kind"] == "poly2" and "coef_c" in col.streams


def test_coefficients_wrap():
    """Coefficients at the ends of the int32 range: the prediction wraps
    mod 2^32 in the plain version as in the reference."""
    rng = np.random.default_rng(52)
    v = gen_column("model", N, rng)
    ref = gt.encode(v, "model", kind="poly2", frame_len=4 * GROUP)
    ref.streams["coef_a"] = np.array([2**31 - 1], np.int32)
    ref.streams["coef_b"] = np.array([-(2**31)], np.int32)
    ref.streams["coef_c"] = np.array([2**31 - 7], np.int32)
    got, want = _decode_both(ref, pad=True)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy()[:N].tobytes() == gtt.decode_ref(gtt.from_reference(ref)).tobytes()


@pytest.mark.parametrize("frame_len", [GROUP, 4 * GROUP])
@pytest.mark.parametrize("kind", ["linear", "poly2"])
def test_prep_matches_reference(kind, frame_len):
    v = arcs(5 * GROUP + 3, frame_len, f"prep{kind}")
    ref = gt.encode(v, "model", kind=kind, frame_len=frame_len)
    want = gt_model.prep(ref)
    got = model.prep(gtt.from_reference(ref))
    assert sorted(got) == sorted(want) == sorted(["packed", "a_g", "b_g"] + (["c_g"] if kind == "poly2" else []))
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == (w.shape if k == "packed" else (w.shape[0],)), k  # (ng, 1) there, (ng,) here
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    # streams already in per-group form pass through, in either shape
    col = gtt.from_reference(ref)
    col.streams = {k: np.asarray(w) for k, w in want.items()}
    assert model.prep(col) is col.streams
    out = gtt.decode(col, device="cpu")
    assert out.numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize("kind", ["linear", "poly2"])
def test_kernel_call_and_cpu_launches_nothing(kind):
    v = gen_column("model", N, np.random.default_rng(53)).astype(np.int16)
    col = gtt.encode(v, "model", kind=kind)
    store = gtt.narrow_store_dtype(col)
    before = kernels.launches()
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), store)
    packed, a_g, b_g, c_g, bits, out_dtype = args
    assert name == "model_decode" and out_dtype == torch.int16 and bits == col.params["bits"]
    assert a_g.shape == b_g.shape == (3,) and (c_g is None) == (kind == "linear")
    out = model.model_decode(*args)
    assert kernels.launches() == before
    assert torch.equal(out, lanes.model_decode(*args))
    assert out.reshape(-1)[:N].numpy().tobytes() == v.tobytes()


def _side(n=2, dtype=torch.int32):
    return torch.zeros(n, dtype=dtype)


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: model.model_decode(torch.zeros((2, 4096), dtype=torch.int32), _side(3), _side(), None, 4), ValueError),
        (lambda: model.model_decode(torch.zeros((2, 4096), dtype=torch.int32), _side(), _side(dtype=torch.int64),
                                    None, 4), TypeError),
        (lambda: model.model_decode(torch.zeros((2, 4096), dtype=torch.int32), _side(), _side(), _side(1), 4),
         ValueError),
        (lambda: model.model_decode(torch.zeros((2, 4096), dtype=torch.int32), _side(), _side(), None, 5),
         ValueError),
        (lambda: model.model_decode(torch.zeros((2, 4096), dtype=torch.int32), _side(), _side(), None, 4,
                                    torch.int64), TypeError),
    ],
)
def test_wrapper_rejects_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()
