"""Data-layout and set-representation ops (SURVEY.md §3.3-3.4).

Counterpart of giddy_tpu/layout.py: libgiddy's gather/scatter building
blocks (of dict decode and patching) and the dense-bitmap <-> sparse-index
conversions, as small torch functions on their tensors' device. The NumPy
twins (``*_np``) serve the oracle and the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .ref.lmp import lmp_pack, lmp_unpack


def gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = data[idx[i]] (libgiddy gather.cuh)."""
    return torch.index_select(data, 0, idx.to(torch.int64))


def scatter(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] = vals[i] (libgiddy scatter.cuh), on a copy of ``out``."""
    return out.clone().index_put_((idx.to(torch.int64),), vals.to(out.dtype))


def bitmap_to_indices(bits: torch.Tensor, max_count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense 0/1 vector -> (indices, count), a fixed-size output: the
    exclusive cumsum of the mask ranks each set position, index j lands at
    slot rank[j], and slots >= count hold len(bits) (a sentinel). Set
    positions ranked past ``max_count`` are dropped. Both int32."""
    n = bits.shape[0]
    mask = bits != 0
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    count = mask.sum(dtype=torch.int32)
    idx = torch.full((max_count + 1,), n, dtype=torch.int32, device=bits.device)
    # unset positions and ranks past the end land on the spare slot max_count
    slot = torch.where(mask & (rank < max_count), rank, max_count)
    idx.index_put_((slot,), torch.arange(n, dtype=torch.int32, device=bits.device).where(mask, n))
    return idx[:max_count], count


def indices_to_bitmap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sparse index list -> dense 0/1 int32 vector. Negative indices count
    from the end, as in NumPy; indices outside [-n, n) are dropped."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    out[torch.where(keep, idx, n)] = 1
    return out[:n]


def bitmap_to_indices_np(bits: np.ndarray) -> np.ndarray:
    return np.nonzero(bits)[0].astype(np.int32)


def indices_to_bitmap_np(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.uint32)
    out[idx] = 1
    return out


def pack_bitmap_np(bits: np.ndarray) -> np.ndarray:
    """Dense 0/1 vector -> LMP(1) words (the incidence-bitmap plane layout)."""
    return lmp_pack(bits.astype(np.uint32), 1)


def unpack_bitmap_np(words: np.ndarray, n: int) -> np.ndarray:
    return lmp_unpack(words, 1, n)
