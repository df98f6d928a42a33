"""Incidence bitmaps — host codec (FORMAT.md §1.8).

The port's copy of giddy_tpu/ref/bitmap.py: one bitmap per distinct value,
bit j of bitmap d set iff out[j] == values[d], each bitmap in the LMP(1)
layout. Decode sums bit · values[d] over the bitmaps (mod 2^32): a sum, not
a select, so a position with two incident bits decodes to the sum.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, LANES, dtype_to_u32, num_groups, sorted_factorize, u32_to_dtype
from .lmp import lmp_pack, lmp_unpack


def encode(values: np.ndarray, *, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    n = values.shape[0]
    u = dtype_to_u32(values)
    uniq, codes = sorted_factorize(u)
    d = int(uniq.shape[0])
    # Pad positions must be incident to exactly one bitmap (FORMAT §1.8):
    # the bitmap of value 0 if present, else bitmap 0.
    zero_idx = int(np.searchsorted(uniq, 0))
    pad_code = zero_idx if zero_idx < d and uniq[zero_idx] == 0 else 0
    ng = num_groups(n)
    codes_pad = np.full(ng * GROUP, pad_code, dtype=np.int64)
    codes_pad[:n] = codes
    if d == 0:  # empty column: no planes, decode yields nothing
        return EncodedColumn(
            name=name, scheme="bitmap", dtype=str(values.dtype), n=0,
            params={"d": 0},
            streams={"bitmaps": np.zeros((0, ng * LANES), np.uint32), "values": np.zeros(0, np.int32)},
        )
    planes = [lmp_pack((codes_pad == dd).astype(np.uint32), 1) for dd in range(d)]
    return EncodedColumn(
        name=name,
        scheme="bitmap",
        dtype=str(values.dtype),
        n=n,
        params={"d": d},
        streams={
            "bitmaps": np.stack(planes).reshape(d, -1),  # (d, ng*LANES) words
            "values": uniq.view(np.int32),
        },
    )


def decode(col: EncodedColumn) -> np.ndarray:
    d = col.params["d"]
    vals = col.streams["values"].view(np.uint32)
    bitmaps = col.streams["bitmaps"].reshape(d, num_groups(col.n), LANES)
    out = np.zeros(col.n, dtype=np.uint32)
    for dd in range(d):
        bit = lmp_unpack(bitmaps[dd], 1, col.n)
        out += bit * vals[dd]
    return u32_to_dtype(out, col.dtype)


registry.register("bitmap", encode, decode)
