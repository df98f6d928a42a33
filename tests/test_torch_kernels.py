"""Each kernel wrapper of giddy_tpu_torch against the JAX decode of the same
column, on the CPU. There the wrapper runs the kernel's plain PyTorch
version (kernels/lanes.py) and giddy_tpu.decode runs its Pallas kernel in
interpret mode. Integer outputs, compared bit for bit over all n_pad
values (tolerance 0). The cases are chip_smoke.py's kernel checks at a
small n; the CUDA kernels themselves are compared with the same plain
versions on the card by chip_smoke.py and test_cuda_kernels_match_plain."""

import zlib

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import lanes
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX

N = 2 * GROUP + 999  # three groups, the last one ragged


# The JAX decodes run in the worker's reference process (test_torch_inputs.JAX),
# so that the xdist worker keeps none of their interpret-mode programs.


def jax_decode(ref, **kw) -> np.ndarray:
    return np.asarray(gt.decode(ref, **kw))


def _uint(rng, bits, n=N):
    return rng.integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32).view(np.int32)


def _dict_values(rng, d, n=N):
    vocab = rng.permutation(np.arange(d, dtype=np.int64) * 65_537 - 2**31 + 12_345).astype(np.int32)
    return vocab[rng.integers(0, d, n)], {"dictionary": vocab}


def _typed(rng, dtype, scheme):
    if dtype == "float32":
        v = rng.normal(0, 1e3, N).astype(np.float32)
    else:
        v = rng.integers(0, 2**31 - 1, N, dtype=np.int64).astype(np.dtype(dtype))
    return v[rng.integers(0, 40, N)] if scheme == "dict" else v


def _case(label):
    """(scheme, values, encode options) of one named case."""
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    kind, _, arg = label.partition(":")
    if kind == "nbit":
        return "nbit", _uint(rng, int(arg)), {"bits": int(arg)}
    if kind == "dzbf":
        return "dzbf", _uint(rng, 8 * int(arg)), {"width": int(arg)}
    if kind == "for":
        v = (1_700_000_000 + rng.integers(0, 4096, N)).astype(np.int32)
        return "for", v, {"frame_len": int(arg) * GROUP}
    if kind == "delta-ts":
        return "delta", (np.cumsum(rng.integers(0, 16, N)) + 1_600_000_000).astype(np.int32), {}
    if kind == "delta-walk":  # negative steps, deltas of >= 25 bits
        return "delta", np.cumsum(rng.integers(-(2**24), 2**24, N)).astype(np.int32), {}
    if kind == "dict":
        return ("dict", *_dict_values(rng, int(arg)))
    if kind == "empty":
        return arg, np.zeros(0, np.int32), {}
    scheme, dtype = arg.split("/")
    return scheme, _typed(rng, dtype, scheme), {}


SCHEMES = ["nbit", "dzbf", "for", "delta", "dict"]
CASES = (
    [f"nbit:{b}" for b in (1, 7, 9, 16, 17, 31, 32)]
    + [f"dzbf:{w}" for w in (1, 2, 3, 4)]
    + ["for:1", "for:2", "delta-ts:", "delta-walk:"]
    + [f"dict:{d}" for d in (1, 40, 1000, 2049, 16384, 65536)]
    # dzbf runs nbit's kernel: its narrow stores are the nbit cases
    + [f"typed:{s}/{t}" for t in ("int8", "int16", "uint16", "float32") for s in SCHEMES if s != "dzbf"]
    + [f"empty:{s}" for s in SCHEMES if s != "dict"]
)


def as_logical(payload: torch.Tensor, dtype: str) -> np.ndarray:
    host = payload.reshape(-1).numpy()
    dt = np.dtype(dtype)
    return host.view(dt) if host.dtype.itemsize == dt.itemsize else host


@pytest.mark.parametrize("label", CASES)
def test_plain_kernel_matches_jax_decode(label):
    scheme, v, opts = _case(label)
    ref = gt.encode(v, scheme, **opts)
    if label == "delta-walk:":
        assert ref.params["bits"] >= 25
    col = gtt.from_reference(ref)
    store = gtt.narrow_store_dtype(col)
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), store)
    before = kernels.launches()
    out = getattr(kernels.WRAPPERS[name], name)(*args)
    assert kernels.launches() == before  # the CPU path launches no kernel
    assert out.dtype == store and out.shape == (args[0].shape[0], GROUP)
    got = as_logical(out, col.dtype)
    want = JAX(jax_decode, ref, pad=True)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert got[: col.n].tobytes() == v.tobytes()


def test_lanes_primitives():
    rng = np.random.default_rng(7)
    z = torch.from_numpy(rng.integers(-(2**31), 2**31, 4096, dtype=np.int64).astype(np.int32))
    want = ((z.numpy().view(np.uint32) >> 1) ^ (-(z.numpy() & 1)).astype(np.uint32)).view(np.int32)
    np.testing.assert_array_equal(lanes.unzigzag(z).numpy(), want)
    d = torch.from_numpy(rng.integers(-(2**31), 2**31, (2, GROUP), dtype=np.int64).astype(np.int32))
    base = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32)
    acc = (np.cumsum(d.numpy().astype(np.int64), axis=1) + base.numpy()[:, None].astype(np.int64))
    np.testing.assert_array_equal(lanes.group_cumsum(d, base).numpy(), acc.astype(np.uint32).view(np.int32))
    table = torch.tensor([5, -6, 7], dtype=torch.int32)
    idx = torch.tensor([[0, 2, 1, 9, -1]], dtype=torch.int32)  # 9 and 2**32-1 clamp to d-1
    assert lanes.gather(table, idx).tolist() == [[5, 7, -6, 7, 7]]
