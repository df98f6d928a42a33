"""NBit bit-packing — host codec (FORMAT.md §1.1; BASELINE configs[0])."""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import bits_needed, dtype_to_u32, u32_to_dtype
from .lmp import lmp_pack, lmp_unpack


def encode(values: np.ndarray, *, bits: int | None = None, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    u = dtype_to_u32(values)
    if bits is None:
        bits = bits_needed(int(u.max(initial=0)))
    return EncodedColumn(
        name=name,
        scheme="nbit",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={"bits": int(bits)},
        streams={"packed": lmp_pack(u, bits)},
    )


def decode(col: EncodedColumn) -> np.ndarray:
    u = lmp_unpack(col.streams["packed"], col.params["bits"], col.n)
    return u32_to_dtype(u, col.dtype)


registry.register("nbit", encode, decode)
