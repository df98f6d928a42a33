"""Discard zero bytes, fixed width — host codec (FORMAT.md §1.9).

NBit with B = 8·w (byte-aligned lane buffers), kept as its own scheme as
in the reference.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import bytes_needed, dtype_to_u32, u32_to_dtype
from .lmp import lmp_pack, lmp_unpack


def encode(values: np.ndarray, *, width: int | None = None, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    u = dtype_to_u32(values)
    if width is None:
        width = bytes_needed(int(u.max(initial=0)))
    if width not in (1, 2, 3, 4):
        raise ValueError(f"width must be 1..4 bytes, got {width}")
    return EncodedColumn(
        name=name,
        scheme="dzbf",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={"width": int(width)},
        streams={"packed": lmp_pack(u, 8 * width)},
    )


def decode(col: EncodedColumn) -> np.ndarray:
    u = lmp_unpack(col.streams["packed"], 8 * col.params["width"], col.n)
    return u32_to_dtype(u, col.dtype)


registry.register("dzbf", encode, decode)
