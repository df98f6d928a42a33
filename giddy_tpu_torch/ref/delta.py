"""Delta with per-group anchors — host codec (FORMAT.md §1.3; BASELINE configs[1]).

The anchor period is the GROUP tile, so every group decodes on its own:
anchors[0] = v[0] and anchors[g] = v[g·GROUP − 1].
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import (
    GROUP,
    bits_needed,
    dtype_to_u32,
    num_groups,
    pad_to_groups,
    u32_to_dtype,
    unzigzag,
    zigzag,
)
from .lmp import lmp_pack, lmp_unpack


def encode(values: np.ndarray, *, bits: int | None = None, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    n = values.shape[0]
    u = dtype_to_u32(values).astype(np.int32, copy=False)  # wrapping arithmetic
    deltas = np.zeros(n, dtype=np.int32)
    if n:
        # delta[0] := 0 — anchors[0] carries v[0] (FORMAT §1.3)
        np.subtract(u[1:], u[:-1], out=deltas[1:])
    z = zigzag(deltas)
    z = pad_to_groups(z)  # tail pad deltas are 0 (repeat last value)
    ng = num_groups(n)
    anchors = np.zeros(ng, dtype=np.int32)
    if n:
        anchors[0] = u[0]
        idx = np.arange(1, ng, dtype=np.int64) * GROUP - 1
        anchors[1:] = u[np.minimum(idx, n - 1)]
    if bits is None:
        bits = bits_needed(int(z.max(initial=0)))
    return EncodedColumn(
        name=name,
        scheme="delta",
        dtype=str(values.dtype),
        n=n,
        params={"bits": int(bits)},
        streams={"packed": lmp_pack(z, bits), "anchors": anchors},
    )


def decode(col: EncodedColumn) -> np.ndarray:
    bits = col.params["bits"]
    ng = num_groups(col.n)
    z = lmp_unpack(col.streams["packed"], bits, ng * GROUP)
    d = unzigzag(z).reshape(ng, GROUP)
    anchors = col.streams["anchors"].astype(np.int32)
    # Per-group inclusive cumsum (wrapping int32) + anchor base.
    acc = np.cumsum(d.astype(np.int64), axis=1)
    u = (acc + anchors[:, None].astype(np.int64)).astype(np.uint32).reshape(-1)[: col.n]
    return u32_to_dtype(u, col.dtype)


registry.register("delta", encode, decode)
