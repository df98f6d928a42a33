"""Input generators shared by the port's CPU tests and its CUDA tests
(test_torch_cuda.py), and tests of the generators themselves. Imports
nothing of JAX, so the CUDA tests can run where JAX is absent."""

import zlib

import numpy as np
import pytest

from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

# NaN, ±Inf, -0.0, values whose v·100 lands at 2^23 - 1, 2^23 and ±(2^23 + 1),
# then the subnormals 1 and 2 ulp, the largest subnormal and -1 ulp
SPECIALS = np.concatenate([
    np.array([np.nan, np.inf, -np.inf, -0.0, (2**23 - 1) / 100, 2**23 / 100, (2**23 + 1) / 100,
              -(2**23 + 1) / 100], np.float32),
    np.array([1, 2, 0x7FFFFF, 0x80000001], np.uint32).view(np.float32),
])


def rng_of(seed: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(seed.encode()))


def salted_prices(n: int, rng: np.random.Generator) -> np.ndarray:
    """Two-decimal float32 prices salted with every value of SPECIALS: at
    the first positions, at random positions (2%), and at 0, n-1 and both
    sides of every group boundary."""
    v = np.round(rng.uniform(0, 1000, n), 2).astype(np.float32)
    if n == 0:
        return v
    edges = np.arange(GROUP, n, GROUP)
    idx = np.concatenate([rng.choice(n, n // 50, replace=False), [0, n - 1], edges - 1, edges])
    v[idx] = SPECIALS[rng.integers(0, SPECIALS.shape[0], idx.shape[0])]
    v[: SPECIALS.shape[0]] = SPECIALS[:n]
    return v


def bitmap_values(d: int, n: int, rng: np.random.Generator, dtype: str = "int32") -> np.ndarray:
    """n values drawn from d distinct random values of dtype (d <= its range)."""
    info = np.iinfo(np.dtype(dtype))
    vocab = rng.choice(np.arange(info.min, info.max + 1, dtype=np.int64), d, replace=False) if info.bits <= 16 else (
        rng.choice(2**31, d, replace=False).astype(np.int64) * rng.choice([-1, 1], d))
    return vocab.astype(np.dtype(dtype))[rng.integers(0, d, n)]


def test_salted_prices_hold_every_special_at_the_group_edges():
    n = 2 * GROUP + 999
    v = salted_prices(n, rng_of("salted"))
    bits = v.view(np.uint32)
    assert v.dtype == np.float32 and v.shape == (n,)
    assert bits[: SPECIALS.shape[0]].tobytes() == SPECIALS.tobytes()
    assert set(SPECIALS.view(np.uint32)) <= set(bits)
    edge = [0, GROUP - 1, GROUP, 2 * GROUP - 1, 2 * GROUP, n - 1]
    assert set(bits[edge]) <= set(SPECIALS.view(np.uint32))
    assert salted_prices(0, rng_of("salted")).shape == (0,)
    assert salted_prices(5, rng_of("salted")).view(np.uint32).tolist() == SPECIALS[:5].view(np.uint32).tolist()


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16", "int32"])
def test_bitmap_values_have_d_distinct_values(dtype):
    d = 12
    v = bitmap_values(d, 4 * GROUP, rng_of(dtype), dtype)
    assert v.dtype == np.dtype(dtype) and v.shape == (4 * GROUP,)
    assert np.unique(v).shape == (d,)
    assert np.array_equal(bitmap_values(d, 100, rng_of(dtype), dtype), bitmap_values(d, 100, rng_of(dtype), dtype))


def test_model_frame_len_default_is_one_group():
    n = 3 * GROUP + 5
    want = gen_column("model", n, rng_of("model"))
    assert gen_column("model", n, rng_of("model"), frame_len=GROUP).tobytes() == want.tobytes()


@pytest.mark.parametrize("frame_len", [GROUP, 4 * GROUP])
def test_model_frames_are_quadratic_plus_noise(frame_len):
    """Each frame of the model column is a quadratic in the position within
    the frame (mod 2^32) plus noise in [-7, 7]: its third differences are
    the noise's, at most (1 + 3 + 3 + 1)·7."""
    n = 2 * frame_len + 77
    v = gen_column("model", n, rng_of(f"arcs{frame_len}"), frame_len=frame_len).view(np.uint32).astype(np.int64)
    for f in range(-(-n // frame_len)):
        seg = v[f * frame_len : (f + 1) * frame_len]
        d3 = np.diff(seg, 3)
        d3 = (d3 + 2**31) % 2**32 - 2**31  # differences of a wrapped sequence, taken mod 2^32
        assert np.abs(d3).max() <= 8 * 7
