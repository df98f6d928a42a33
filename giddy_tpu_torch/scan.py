"""Standalone per-GROUP scan and reduction (counterpart of giddy_tpu/scan.py).

``group_prefix_sum`` runs kernel K6 (kernels/cumsum.py) on a CUDA tensor
and its plain version on a CPU tensor; ``group_reduce`` is torch ops, as
the reference's is jnp. Both take flat tensors of any length, padded
internally to GROUP tiles.
"""

from __future__ import annotations

import torch

from .kernels.cumsum import cumsum_rows
from .kernels.lanes import wrap32
from .util import GROUP, num_groups


def group_prefix_sum(x: torch.Tensor, *, exclusive: bool = False) -> torch.Tensor:
    """Inclusive (or exclusive) prefix sum within each GROUP tile, wrapping
    uint32; returns a uint32 tensor of x's length on x's device."""
    n = x.shape[0]
    ng = num_groups(n)
    xu = x.view(torch.int32) if x.dtype == torch.uint32 else x.to(torch.int32)
    dense = torch.zeros(ng * GROUP, dtype=torch.int32, device=x.device)
    dense[:n] = xu
    out = cumsum_rows(dense.view(ng, GROUP)).reshape(-1)
    if exclusive:
        out = out - dense
    return out[:n].view(torch.uint32)


_REDUCE = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}


def group_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Per-GROUP reduction -> (num_groups,) tensor. ops: sum|max|min.

    Integer dtypes of up to 32 bits, as the reference (its pad fill comes
    from iinfo). Reduced in int64; max and min come back in x's dtype, a sum
    wraps to int32 (uint32 for unsigned x), as jnp.sum's does."""
    n = x.shape[0]
    ng = num_groups(n)
    info = torch.iinfo(x.dtype)
    fill = {"sum": 0, "max": info.min, "min": info.max}[op]
    padded = torch.full((ng * GROUP,), fill, dtype=torch.int64, device=x.device)
    padded[:n] = x.to(torch.int64)
    out = _REDUCE[op](padded.view(ng, GROUP), dim=1)
    if op != "sum":
        return out.to(x.dtype)
    return wrap32(out) if info.min < 0 else (out & 0xFFFFFFFF).to(torch.uint32)
