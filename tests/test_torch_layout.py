"""giddy_tpu_torch.layout against giddy_tpu.layout on the CPU, from the
same numpy-seeded inputs: gather and scatter, the dense-bitmap <->
sparse-index conversions (with the fixed-size output's sentinel slots and
dropped overflow) and their NumPy twins. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from giddy_tpu import layout as jl
from giddy_tpu_torch import layout
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import rng_of

N = 2 * GROUP + 999


@pytest.mark.parametrize("n", [N, 1, 0])
def test_gather_scatter_match_jax(n):
    rng = rng_of(f"layout/gather/{n}")
    data = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    g = layout.gather(torch.from_numpy(data), torch.from_numpy(perm))
    want = jl.gather(jnp.asarray(data), jnp.asarray(perm))
    assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(want))
    s = layout.scatter(torch.zeros(n, dtype=torch.int32), torch.from_numpy(perm), g)
    assert np.array_equal(s.numpy(), np.asarray(jl.scatter(jnp.zeros(n, jnp.int32), jnp.asarray(perm), want)))
    assert np.array_equal(s.numpy(), data)
    idx = rng.integers(0, max(n, 1), 2 * n).astype(np.int32) if n else np.zeros(0, np.int32)
    assert np.array_equal(layout.gather(torch.from_numpy(data), torch.from_numpy(idx)).numpy(),
                          np.asarray(jl.gather(jnp.asarray(data), jnp.asarray(idx))))


@pytest.mark.parametrize("density,max_count", [(0.03, 4096), (0.5, 100), (0.0, 8), (1.0, N)])
def test_bitmap_indices_match_jax(density, max_count):
    rng = rng_of(f"layout/bits/{density}/{max_count}")
    bits = (rng.random(N) < density).astype(np.uint32)
    idx, count = layout.bitmap_to_indices(torch.from_numpy(bits.view(np.int32)), max_count)
    widx, wcount = jl.bitmap_to_indices(jnp.asarray(bits), max_count)
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), np.asarray(widx))
    assert int(count) == int(wcount) == int(bits.sum())
    back = layout.indices_to_bitmap(torch.from_numpy(np.append(layout.bitmap_to_indices_np(bits), [N, -1])), N)
    assert np.array_equal(back.numpy()[:-1], bits[:-1])
    want = jl.indices_to_bitmap(jnp.asarray(np.append(jl.bitmap_to_indices_np(bits), [N, -1])), N)
    assert np.array_equal(back.numpy(), np.asarray(want).astype(np.int32))
    tail = np.array([-1, -N, -N - 1, N, 3], np.int32)  # negatives count from the end; the rest drop
    assert np.array_equal(layout.indices_to_bitmap(torch.from_numpy(tail), N).numpy(),
                          np.asarray(jl.indices_to_bitmap(jnp.asarray(tail), N)).astype(np.int32))


def test_numpy_twins_match_jax():
    rng = rng_of("layout/np")
    bits = (rng.random(N) < 0.5).astype(np.uint32)
    assert np.array_equal(layout.bitmap_to_indices_np(bits), jl.bitmap_to_indices_np(bits))
    idx = layout.bitmap_to_indices_np(bits)
    assert np.array_equal(layout.indices_to_bitmap_np(idx, N), jl.indices_to_bitmap_np(idx, N))
    words = layout.pack_bitmap_np(bits)
    assert words.tobytes() == jl.pack_bitmap_np(bits).tobytes()
    assert np.array_equal(layout.unpack_bitmap_np(words, N), bits)
