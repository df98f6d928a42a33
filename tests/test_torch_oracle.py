"""giddy_tpu_torch's decode against its NumPy oracle and the input, on the
CPU, for every scheme the reference decodes on the device: the port's
counterpart of tests/test_device_vs_oracle.py, with the same schemes, data
and edges. Through ``decode(col, device="cpu")`` every decoder runs its
kernels' plain versions. Imports nothing of JAX. Bit for bit (tolerance 0)."""

import numpy as np
import pytest

import giddy_tpu_torch as gtt
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

SCHEMES = ["nbit", "for", "delta", "delta2", "dict", "rle", "rpe", "model", "bitmap", "dzbf", "dzbv", "patched",
           "raw", "xordelta", "alp"]


def decode(col) -> np.ndarray:
    out = gtt.decode(col, device="cpu").numpy()
    assert out.dtype == np.dtype(col.dtype) and out.shape == (col.n,)
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_matches_oracle(scheme):
    v = gen_column(scheme, 2 * GROUP + 999, np.random.default_rng(1234))
    col = gtt.encode(v, scheme)
    out = decode(col)
    assert out.tobytes() == gtt.decode_ref(col).tobytes() == v.tobytes()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_matches_oracle_hard(scheme):
    v = gen_column(scheme, GROUP, np.random.default_rng(99), hard=True)
    col = gtt.encode(v, scheme)
    assert decode(col).tobytes() == gtt.decode_ref(col).tobytes() == v.tobytes()


@pytest.mark.parametrize("bits", [1, 7, 9, 16, 17, 31, 32])
def test_nbit_widths(bits):
    rng = np.random.default_rng(bits)
    v = rng.integers(0, 2**bits, GROUP + 1, dtype=np.uint64).astype(np.uint32).view(np.int32)
    assert decode(gtt.encode(v, "nbit", bits=bits)).tobytes() == v.tobytes()


def test_patched_compressed():
    v = gen_column("patched", 3 * GROUP, np.random.default_rng(5))
    assert decode(gtt.encode(v, "patched", kind="compressed")).tobytes() == v.tobytes()


@pytest.mark.parametrize("scheme", SCHEMES + ["cascade"])
def test_empty_column(scheme):
    v = gen_column(scheme, 0, np.random.default_rng(0))
    col = gtt.encode(v, scheme)
    assert decode(col).shape == (0,) and gtt.decode_ref(col).shape == (0,)
    assert gtt.decode(col, device="cpu", pad=True).shape == (GROUP,)


def test_adversarial_edges():
    """A dictionary of one value, one run over the whole column (rle, rpe),
    and patching where all but a few values are exceptions."""
    n = 2 * GROUP + 999
    const = np.full(n, -7, np.int32)
    for scheme in ("dict", "rle", "rpe"):
        assert decode(gtt.encode(const, scheme)).tobytes() == const.tobytes()
    spread = np.random.default_rng(2).integers(2, 2**20, n, dtype=np.int64).astype(np.int32)
    for kind in ("naive", "compressed"):
        col = gtt.encode(spread, "patched", kind=kind, bits=1)
        assert col.params["count"] >= 0.99 * n
        assert decode(col).tobytes() == gtt.decode_ref(col).tobytes() == spread.tobytes()
