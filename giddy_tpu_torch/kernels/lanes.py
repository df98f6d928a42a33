"""Plain PyTorch versions of the four decode kernels (csrc/lmp_decode.cu).

The counterpart of Pallas interpret mode: the same arithmetic in torch
ops, at the same signatures as the kernel wrappers. The wrappers take them
for CPU tensors only; ``chip_smoke.py`` also runs them on the card to hold
each kernel against them.

Payloads ride as int32 tensors carrying the uint32 bits: torch on the CPU
lacks most uint32 arithmetic. So a logical right shift masks off the sign
extension, and the wrapping cumsum runs in int64 and is cut back to 32 bits.
"""

from __future__ import annotations

import torch

from ..util import GROUP, LANES, SLOTS


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-carried uint32 bits."""
    return x if s == 0 else (x >> s) & ((1 << (32 - s)) - 1)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (mod 2^32)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def unpack_lanes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """LMP unpack: (ng, bits*LANES) words -> (ng, GROUP) values, in linear
    order (position i*LANES + c is slot i of lane c, FORMAT.md §0.1)."""
    ng = packed.shape[0]
    words = packed.reshape(ng, bits, LANES)
    out = torch.empty((ng, SLOTS, LANES), dtype=torch.int32, device=packed.device)
    for i in range(SLOTS):
        w0, s = divmod(i * bits, 32)
        v = _srl(words[:, w0], s)
        if s + bits > 32:
            v = v | (words[:, w0 + 1] << (32 - s))
        out[:, i] = v if bits == 32 else v & ((1 << bits) - 1)
    return out.reshape(ng, GROUP)


def unzigzag(z: torch.Tensor) -> torch.Tensor:
    """Unsigned zigzag -> signed int32 (FORMAT.md §0.2)."""
    return _srl(z, 1) ^ -(z & 1)


def group_cumsum(d: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along each (ng, GROUP) row plus base[g], mod 2^32."""
    return _wrap32(torch.cumsum(d.to(torch.int64), dim=1) + base.to(torch.int64)[:, None])


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with the codes read as unsigned and clamped to the table,
    as the kernel does."""
    i = idx.to(torch.int64) & 0xFFFFFFFF
    return table[i.clamp_(max=table.shape[0] - 1)]


def lmp_unpack(packed: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return unpack_lanes(packed, bits).to(out_dtype)


def for_unpack(packed: torch.Tensor, refs_g: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return (unpack_lanes(packed, bits) + refs_g[:, None]).to(out_dtype)


def delta_decode(packed: torch.Tensor, anchors: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return group_cumsum(unzigzag(unpack_lanes(packed, bits)), anchors).to(out_dtype)


def dict_decode(codes: torch.Tensor, values: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return gather(values, unpack_lanes(codes, bits)).to(out_dtype)
