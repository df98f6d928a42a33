"""giddy_tpu_torch's per-group scan family against giddy_tpu's, on the CPU:
delta2 (K7) and xordelta (K8) encode and decode, and scan.group_prefix_sum
(K6) / group_reduce. The port runs the kernels' plain versions, the JAX
package its Pallas kernels in interpret mode. Everything is compared bit
for bit (tolerance 0). Last, a NumPy model of K7's chunked scan against
the plain version."""

import zlib

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu.scan as gt_scan
import giddy_tpu_torch as gtt
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import delta2, lanes, xordelta
from giddy_tpu_torch.ref.lmp import lmp_pack, lmp_unpack
from giddy_tpu_torch.util import GROUP

from helpers import gen_column
from test_torch_host import assert_same_column

N = 2 * GROUP + 999  # three groups, the last one ragged
SCHEMES = ["delta2", "xordelta"]


def values(label: str, n: int = N) -> np.ndarray:
    """delta2-ts (jittered timestamps), delta2-walk (random walk, >= 25-bit
    second differences), xordelta-float (slowly varying float32), and the
    reference generator's hard cases."""
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    if label == "delta2-walk":
        return np.cumsum(rng.integers(-(2**24), 2**24, n)).astype(np.int32)
    scheme, _, kind = label.partition("-")
    return gen_column(scheme, n, rng, hard=kind == "hard")


CASES = ["delta2-ts", "delta2-walk", "delta2-hard", "xordelta-float", "xordelta-hard"]


@pytest.mark.parametrize("n", [N, GROUP, 1, 0])
@pytest.mark.parametrize("label", CASES)
def test_encode_matches_reference(label, n):
    v = values(label, n)
    scheme = label.split("-")[0]
    port = gtt.encode(v, scheme, name="c")
    assert_same_column(port, gt.encode(v, scheme, name="c"))
    assert gtt.decode_ref(port).tobytes() == v.tobytes()
    if label == "delta2-walk" and n == N:
        assert port.params["bits"] >= 25


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "uint32", "float32"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_and_oracle_dtypes_match_reference(scheme, dtype):
    rng = np.random.default_rng(52)
    raw = rng.integers(0, 2**32, GROUP + 77, dtype=np.uint64).astype(np.uint32)
    v = raw.view(np.float32) if dtype == "float32" else raw.astype(np.dtype(dtype))
    port, ref = gtt.encode(v, scheme), gt.encode(v, scheme)
    assert_same_column(port, ref)
    assert gtt.decode_ref(port).tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()


@pytest.mark.parametrize("dtype", ["int32", "uint8", "int16", "float32"])
@pytest.mark.parametrize("label", CASES)
def test_decode_matches_jax_and_input(label, dtype):
    scheme = label.split("-")[0]
    v = values(label)
    v = v.view(np.float32) if dtype == "float32" else v.astype(np.dtype(dtype))
    ref = gt.encode(v, scheme)
    out = gtt.decode(gtt.from_reference(ref), device="cpu")
    assert out.dtype == getattr(torch, dtype) and out.shape == (N,)
    assert out.numpy().tobytes() == np.asarray(gt.decode(ref)).tobytes() == v.tobytes()


@pytest.mark.parametrize("label", CASES)
def test_kernel_plain_version_matches_jax_pad(label):
    """The wrapper's plain version over all n_pad values against the JAX
    decode with pad=True; the CPU path launches no kernel."""
    scheme = label.split("-")[0]
    ref = gt.encode(values(label).astype(np.int16), scheme)
    col = gtt.from_reference(ref)
    store = gtt.narrow_store_dtype(col)
    assert store == (torch.int16 if scheme == "delta2" else torch.int32)  # xordelta: no narrow store
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), store)
    assert name == f"{scheme}_decode"
    before = kernels.launches()
    out = getattr(kernels.WRAPPERS[name], name)(*args)
    assert kernels.launches() == before
    assert out.dtype == store and out.shape == (3, GROUP)
    got = out.reshape(-1).to(torch.int16).numpy()
    assert got.tobytes() == np.asarray(gt.decode(ref, pad=True)).tobytes()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_pad_and_empty(scheme):
    ref = gt.encode(values(f"{scheme}-hard"), scheme)
    out = gtt.decode(gtt.from_reference(ref), device="cpu", pad=True)
    assert out.shape == (3 * GROUP,)
    assert out.numpy().tobytes() == np.asarray(gt.decode(ref, pad=True)).tobytes()
    empty = gtt.decode(gtt.encode(np.zeros(0, np.int16), scheme), device="cpu")
    assert empty.shape == (0,) and empty.dtype == torch.int16
    padded = gtt.decode(gtt.encode(np.zeros(0, np.int32), scheme), device="cpu", pad=True)
    assert padded.shape == (GROUP,) and not padded.any()


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int16", "uint8"])
@pytest.mark.parametrize("n", [N, GROUP, 5, 0])
@pytest.mark.parametrize("exclusive", [False, True])
def test_group_prefix_sum_matches_jax(exclusive, n, dtype):
    rng = np.random.default_rng(53 + n)
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x = x.view(np.int32) if dtype == "int32" else x.astype(np.dtype(dtype))
    got = gtt.scan.group_prefix_sum(torch.from_numpy(x), exclusive=exclusive)
    want = np.asarray(gt_scan.group_prefix_sum(x, exclusive=exclusive))
    assert got.dtype == torch.uint32 and got.shape == (n,)
    assert got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["int32", "int16", "uint8"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_group_reduce_matches_jax(op, dtype):
    rng = np.random.default_rng(54)
    x = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    x = x.view(np.int32) if dtype == "int32" else x.astype(np.dtype(dtype))
    got = gtt.scan.group_reduce(torch.from_numpy(x), op).numpy()
    want = np.asarray(gt_scan.group_reduce(x, op))
    assert got.shape == (3,) and got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_scan_plain_versions():
    """cumsum_rows and the log-step prefix XOR against NumPy's
    accumulations, on random full-width rows."""
    rng = np.random.default_rng(55)
    x = rng.integers(0, 2**32, (2, GROUP), dtype=np.uint64).astype(np.uint32)
    rows = torch.from_numpy(x.view(np.int32))
    want = np.cumsum(x.astype(np.uint64), axis=1).astype(np.uint32)
    assert lanes.cumsum_rows(rows).numpy().view(np.uint32).tobytes() == want.tobytes()
    assert torch.equal(lanes.cumsum_rows(rows, torch.uint8), lanes.cumsum_rows(rows).to(torch.uint8))
    packed = torch.from_numpy(lmp_pack(x.reshape(-1), 32).view(np.int32))
    anchors = torch.tensor([7, -1], dtype=torch.int32)
    got = xordelta.xordelta_decode(packed, anchors, 32).numpy().view(np.uint32)
    want = np.bitwise_xor.accumulate(x, axis=1) ^ anchors.numpy().view(np.uint32)[:, None]
    assert got.tobytes() == want.tobytes()
    slopes = torch.tensor([2**31 - 1, 3], dtype=torch.int32)
    out = delta2.delta2_decode(packed, anchors, slopes, 32).numpy().view(np.uint32)
    z = x.astype(np.int64)
    cc = np.cumsum(np.cumsum((z >> 1) ^ -(z & 1), axis=1), axis=1)  # unzigzag, exact in int64
    want = (anchors.numpy().astype(np.int64)[:, None] + slopes.numpy().astype(np.int64)[:, None]
            * np.arange(1, GROUP + 1) + cc).astype(np.uint32)
    assert out.tobytes() == want.tobytes()


def delta2_chunk_model(s: np.ndarray, anchors: np.ndarray, slopes: np.ndarray) -> np.ndarray:
    """K7's algebra in NumPy (csrc/run_decode.cu delta2_decode_kernel), all
    uint32 and wrapping: (ng, GROUP) second differences -> (ng, GROUP)
    values. Two passes of 16 slots; in a pass, chunk e = 64 * slot + 2 *
    warp + half is the 16 positions 16e .. 16e + 15 of the pass, so its
    chunks in (slot, warp, half) order are the pass in order. Each chunk's
    sums (sum s, sum j * s), their exclusive scan over the pass's 1024
    chunks carried on from the first pass's total, then each chunk from
    v_{j0-1} = anchor + j0 * (slope + A) - B with two adds a value,
    v_j = v_{j-1} + slope + S_j."""
    ng = s.shape[0]
    half = GROUP // 2
    k = np.arange(16, dtype=np.uint32)
    carry = np.zeros((2, ng), np.uint32)
    out = np.empty((ng, GROUP), np.uint32)
    for p in range(2):
        chunk = s[:, p * half : (p + 1) * half].reshape(ng, 1024, 16)
        j = np.arange(p * half, (p + 1) * half, dtype=np.uint32).reshape(1024, 16)
        j0 = j[:, 0]
        sums = chunk.sum(axis=2, dtype=np.uint32)
        jsums = j0 * sums + (chunk * k).sum(axis=2, dtype=np.uint32)
        assert np.array_equal(jsums, (chunk * j).sum(axis=2, dtype=np.uint32))
        a = carry[0][:, None] + np.cumsum(sums, axis=1, dtype=np.uint32) - sums  # exclusive
        b = carry[1][:, None] + np.cumsum(jsums, axis=1, dtype=np.uint32) - jsums
        carry = carry + np.stack([sums.sum(axis=1, dtype=np.uint32), jsums.sum(axis=1, dtype=np.uint32)])
        step = slopes[:, None] + a  # slope + S_{j0-1}
        v = anchors[:, None] + j0 * step - b  # v_{j0-1}
        part = np.empty((ng, 1024, 16), np.uint32)
        for i in range(16):
            step = step + chunk[:, :, i]
            v = v + step
            part[:, :, i] = v
        out[:, p * half : (p + 1) * half] = part.reshape(ng, half)
    return out


@pytest.mark.parametrize("bits", [1, 3, 17, 32])
def test_delta2_chunk_model_matches_plain_version(bits):
    """The formula K7 implements, on random second differences of every
    width and anchors and slopes across the int32 range (each sum wraps mod
    2^32 many times at 32 bits), against lanes.delta2_decode."""
    rng = np.random.default_rng(56 + bits)
    ng = 3
    packed = rng.integers(0, 2**32, (ng, bits * 1024), dtype=np.uint64).astype(np.uint32)
    anchors = rng.integers(-(2**31), 2**31, ng).astype(np.int32)
    slopes = np.array([2**31 - 1, -(2**31), int(rng.integers(-(2**31), 2**31))], np.int32)
    z = lmp_unpack(packed.reshape(-1), bits, ng * GROUP).reshape(ng, GROUP)
    s = (z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))
    got = delta2_chunk_model(s, anchors.view(np.uint32), slopes.view(np.uint32))
    want = lanes.delta2_decode(torch.from_numpy(packed.view(np.int32)), torch.from_numpy(anchors),
                               torch.from_numpy(slopes), bits)
    assert got.tobytes() == want.numpy().view(np.uint32).tobytes()


@pytest.mark.parametrize("limit", [1, 22_144, 65_535])
def test_delta2_shared_lut_limit_bisects_the_probe(monkeypatch, limit):
    """shared_lut_limit finds the largest d that K7's probe keeps in shared
    memory (on the card, the C entry gt_delta2_shared; here a stand-in)."""
    monkeypatch.setattr(delta2, "lut_in_shared", lambda d: d <= limit)
    assert delta2.shared_lut_limit() == limit
