"""giddy_tpu_torch's patched scheme against giddy_tpu's, on the CPU: encode,
the host prep, and decode through K9's plain version (after K3's for the
compressed kind's positions) against the JAX decode (Pallas interpret
mode), the NumPy oracle and the input. Everything is compared bit for bit
(tolerance 0)."""

import zlib

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu.kernels import patch as gt_patch
from giddy_tpu.ref import patch as gt_ref_patch
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import lanes, patch
from giddy_tpu_torch.util import GROUP

from test_torch_host import assert_same_column
from test_torch_inputs import JAX

N = 2 * GROUP + 999  # three groups, the last one ragged


# The JAX decodes run in the worker's reference process (test_torch_inputs.JAX),
# so that the xdist worker keeps none of their interpret-mode programs.


def jax_decode(ref, **kw) -> np.ndarray:
    return np.asarray(gt.decode(ref, **kw))
DTYPES = ["int32", "int8", "int16", "uint16", "float32"]


def values(dtype: str, n: int, seed: str, exceptions: bool = True) -> np.ndarray:
    """4-bit values with ~1% wide exceptions, among them positions 0, n-1
    and both sides of every group boundary; narrow dtypes truncate."""
    rng = np.random.default_rng(zlib.crc32(seed.encode()))
    v = rng.integers(0, 16, n, dtype=np.int64)
    if exceptions and n:
        edges = np.arange(GROUP, n, GROUP)
        idx = np.concatenate([rng.choice(n, max(1, n // 100), replace=False), [0, n - 1], edges - 1, edges])
        v[idx] = rng.integers(2**20, 2**31, idx.shape[0])
    u = v.astype(np.uint32)
    return u.view(np.dtype(dtype)) if dtype in ("int32", "float32") else u.astype(np.dtype(dtype))


def _decode_both(ref, **kw):
    out = gtt.decode(gtt.from_reference(ref), device="cpu", **kw)
    return out, JAX(jax_decode, ref, **kw)


@pytest.mark.parametrize("n", [N, GROUP, 0])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["naive", "compressed"])
@pytest.mark.parametrize("base", ["for", "nbit"])
def test_patched_matches_jax_oracle_and_input(base, kind, dtype, n):
    v = values(dtype, n, f"{base}{kind}{dtype}{n}")
    port = gtt.encode(v, "patched", base_scheme=base, kind=kind, name="c")
    ref = gt.encode(v, "patched", base_scheme=base, kind=kind, name="c")
    assert_same_column(port, ref)
    if n and dtype != "int8":  # int8 truncation may leave no value past the base width
        assert port.params["count"] > 0
    assert gtt.decode_ref(port).tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()
    got, want = _decode_both(ref, pad=True)
    assert got.shape == (max(1, -(-n // GROUP)) * GROUP,)
    assert got.numpy().tobytes() == want.tobytes()
    out = gtt.decode(port, device="cpu")
    assert out.dtype == getattr(torch, dtype) and out.numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize("frame_len", [GROUP, 2 * GROUP])
@pytest.mark.parametrize("kind", ["naive", "compressed"])
@pytest.mark.parametrize("base", ["for", "nbit"])
def test_prep_matches_reference(base, kind, frame_len):
    v = values("int32", N + 2 * GROUP, "prep")
    ref = gt.encode(v, "patched", base_scheme=base, kind=kind, frame_len=frame_len)
    want = gt_patch.prep(ref)
    got = patch.prep(gtt.from_reference(ref))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        if k == "base_refs_g":  # (ng, 1) in the reference, (ng,) here: the same bytes
            assert got[k].shape == (w.shape[0],)
        else:
            assert got[k].shape == w.shape, k
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    out, jax_out = _decode_both(ref)
    assert out.numpy().tobytes() == jax_out.tobytes() == v.tobytes()


@pytest.mark.parametrize("n", [N, GROUP, 1])
@pytest.mark.parametrize("kind", ["naive", "compressed"])
def test_no_exceptions(kind, n):
    v = values("int32", n, "none", exceptions=False)
    ref = gt.encode(v, "patched", kind=kind)
    col = gtt.from_reference(ref)
    assert col.params["count"] == 0
    got, want = _decode_both(ref, pad=True)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy()[:n].tobytes() == v.tobytes()
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), torch.int32)
    assert name == "patched_decode" and args[2].shape == (0,) and args[3].shape == (0,)


@pytest.mark.parametrize("kind", ["naive", "compressed"])
def test_kernel_call_positions_and_cpu_launches_nothing(kind):
    v = values("int16", N, "call")
    col = gtt.encode(v, "patched", base_scheme="nbit", kind=kind)
    store = gtt.narrow_store_dtype(col)
    assert store == torch.int16
    before = kernels.launches()
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), store)
    packed, refs_g, pos, val, bits, out_dtype = args
    assert name == "patched_decode" and refs_g is None and bits == col.params["base_params"]["bits"]
    assert pos.dtype == torch.int32 and pos.shape == (col.params["count"],) and bool((pos[1:] > pos[:-1]).all())
    want = gt_ref_patch._decode_positions(gt.encode(v, "patched", base_scheme="nbit", kind=kind))
    np.testing.assert_array_equal(pos.numpy(), want)
    out = patch.patched_decode(*args)
    assert kernels.launches() == before
    assert out.dtype == torch.int16 and out.shape == (3, GROUP)
    assert out.reshape(-1)[:N].numpy().tobytes() == v.tobytes()


def test_plain_version_writes_exceptions_last():
    packed = torch.zeros((2, 4 * 1024), dtype=torch.int32)  # all-zero 4-bit base
    refs_g = torch.tensor([7, -1], dtype=torch.int32)
    pos = torch.tensor([0, GROUP - 1, GROUP, 2 * GROUP - 1], dtype=torch.int32)
    val = torch.tensor([1, 2, 3, 0x12345], dtype=torch.int32)
    out = lanes.patched_decode(packed, refs_g, pos, val, 4).reshape(-1)
    assert out[pos.long()].tolist() == [1, 2, 3, 0x12345]
    assert out[1].item() == 7 and out[GROUP + 1].item() == -1
    narrow = lanes.patched_decode(packed, None, pos, val, 4, torch.uint8).reshape(-1)
    assert narrow[pos.long()].tolist() == [1, 2, 3, 0x45] and narrow[1].item() == 0


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: patch.patched_decode(torch.zeros((1, 4096), dtype=torch.int32), None,
                                      torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int32), 4),
         ValueError),
        (lambda: patch.patched_decode(torch.zeros((1, 4096), dtype=torch.int32), None,
                                      torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int32), 4),
         ValueError),
        (lambda: patch.patched_decode(torch.zeros((2, 4096), dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
                                      torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 4),
         ValueError),
    ],
)
def test_wrapper_rejects_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()
