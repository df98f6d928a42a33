"""XOR-delta with per-group anchors — host codec (FORMAT.md §1.15).

The port's copy of giddy_tpu/ref/xordelta.py: consecutive bitpatterns
XOR, so slowly varying floats pack narrow; decode is a per-group
inclusive prefix-XOR plus the group's anchor.
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
)
from .lmp import lmp_pack, lmp_unpack


def encode(values: np.ndarray, *, bits: int | None = None, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    n = values.shape[0]
    u = dtype_to_u32(values)
    z = np.zeros(n, dtype=np.uint32)
    if n:
        # z[0] := 0 — anchors[0] carries u[0] (mirrors delta, FORMAT §1.3)
        np.bitwise_xor(u[1:], u[:-1], out=z[1:])
    z = pad_to_groups(z)  # tail pad XORs are 0 (repeat last value)
    ng = num_groups(n)
    if n:
        idx = np.concatenate(
            ([0], np.minimum(np.arange(1, ng, dtype=np.int64) * GROUP - 1, n - 1))
        )
        anchors = u[idx].view(np.int32)
    else:
        anchors = np.zeros(ng, dtype=np.int32)
    if bits is None:
        bits = bits_needed(int(z.max(initial=0)))
    return EncodedColumn(
        name=name,
        scheme="xordelta",
        dtype=str(values.dtype),
        n=n,
        params={"bits": int(bits)},
        streams={"packed": lmp_pack(z, bits), "anchors": anchors},
    )


def decode(col: EncodedColumn) -> np.ndarray:
    bits = col.params["bits"]
    ng = num_groups(col.n)
    z = lmp_unpack(col.streams["packed"], bits, ng * GROUP).reshape(ng, GROUP)
    anchors = col.streams["anchors"].view(np.uint32)
    acc = np.bitwise_xor.accumulate(z, axis=1)
    u = (acc ^ anchors[:, None]).reshape(-1)[: col.n]
    return u32_to_dtype(u, col.dtype)


registry.register("xordelta", encode, decode)
