"""Frame-of-reference — host codec (FORMAT.md §1.2).

Frames align to GROUP multiples so a frame reference never straddles a
decode tile.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, bits_needed, cdiv, dtype_to_u32, pad_to_groups, u32_to_dtype
from .lmp import lmp_pack, lmp_unpack


def encode(
    values: np.ndarray,
    *,
    bits: int | None = None,
    frame_len: int = GROUP,
    name: str = "col",
) -> EncodedColumn:
    if frame_len % GROUP:
        raise ValueError(f"frame_len must be a multiple of GROUP={GROUP}")
    values = np.asarray(values)
    n = values.shape[0]
    u32 = dtype_to_u32(values)
    # Pad with the last value, not zero: a zero tail would drag the final
    # frame's reference to 0 and blow up the offset bit width.
    fill = int(u32[-1]) if n else 0
    u = pad_to_groups(u32, fill=fill)
    n_pad = u.shape[0]
    nf = cdiv(n_pad, frame_len)
    upad = np.full(nf * frame_len, fill, dtype=np.uint32)
    upad[:n_pad] = u
    frames = upad.reshape(nf, frame_len)
    # Reference = per-frame min (unsigned): offsets are then all >= 0.
    refs = frames.min(axis=1)
    offs = (frames - refs[:, None]).reshape(-1)[:n_pad]
    if bits is None:
        bits = bits_needed(int(offs.max(initial=0)))
    return EncodedColumn(
        name=name,
        scheme="for",
        dtype=str(values.dtype),
        n=n,
        params={"bits": int(bits), "frame_len": int(frame_len)},
        streams={
            "packed": lmp_pack(offs, bits),
            "refs": refs.astype(np.int32).reshape(-1),
        },
    )


def decode(col: EncodedColumn) -> np.ndarray:
    bits, frame_len = col.params["bits"], col.params["frame_len"]
    offs = lmp_unpack(col.streams["packed"], bits, col.n)
    refs = col.streams["refs"].astype(np.uint32)
    fidx = np.arange(col.n, dtype=np.int64) // frame_len
    u = (refs[fidx] + offs).astype(np.uint32)  # wrapping add
    return u32_to_dtype(u, col.dtype)


registry.register("for", encode, decode)
