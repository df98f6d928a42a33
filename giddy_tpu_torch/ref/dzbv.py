"""Discard zero bytes, variable width — host codec (FORMAT.md §1.10).

Each value keeps only its low ``w`` bytes, w in 1..4 the fewest that hold
it: a 2-bit stream of w - 1 (``widths``, LMP(2)) and four compacted byte
planes (``plane{k}``, LMP(8)): plane k holds byte k of every value with
w > k, in order. The port's copy of giddy_tpu/ref/dzbv.py: the split runs
in one pass of the C++ host codec where it is built (native.py), else in
NumPy; both write the same bytes.
"""

from __future__ import annotations

import numpy as np

from .. import native, registry
from ..format import EncodedColumn
from ..util import dtype_to_u32, u32_to_dtype
from .lmp import lmp_pack, lmp_unpack


def split(u: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]]:
    """(w - 1 as uint32, [plane0 .. plane3] as uint32 byte values) of
    uint32 values u."""
    nat = native.dzbv_split(u)
    if nat is not None:
        return nat
    # width w[j] in [1,4] = smallest byte count holding u[j]
    w = np.ones(u.shape[0], dtype=np.int32)
    w[u > 0xFF] = 2
    w[u > 0xFFFF] = 3
    w[u > 0xFFFFFF] = 4
    # plane0 holds byte 0 of all elements
    planes = [((u[w > k] if k else u) >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    return (w - 1).astype(np.uint32), planes


def encode(values: np.ndarray, *, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    wm1, planes = split(dtype_to_u32(values))
    streams = {"widths": lmp_pack(wm1, 2)}
    for k, plane in enumerate(planes):
        streams[f"plane{k}"] = lmp_pack(plane, 8)
    return EncodedColumn(
        name=name,
        scheme="dzbv",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={"plane_lens": [int(p.shape[0]) for p in planes]},
        streams=streams,
    )


def decode(col: EncodedColumn) -> np.ndarray:
    n = col.n
    plane_lens = col.params["plane_lens"]
    w = lmp_unpack(col.streams["widths"], 2, n).astype(np.int32) + 1
    out = lmp_unpack(col.streams["plane0"], 8, plane_lens[0])[:n].copy()
    for k in (1, 2, 3):
        mask = w > k
        m = plane_lens[k]
        if m == 0:
            continue
        plane = lmp_unpack(col.streams[f"plane{k}"], 8, m)
        rank = np.cumsum(mask) - 1  # inclusive rank among selected
        vals = plane[np.where(mask, rank, 0)]
        out |= np.where(mask, vals, 0).astype(np.uint32) << np.uint32(8 * k)
    return u32_to_dtype(out, col.dtype)


registry.register("dzbv", encode, decode)
