"""Delta-of-delta with per-group anchor + slope — host codec (FORMAT.md §1.17).

The port's copy of giddy_tpu/ref/delta2.py. With ``s`` the packed second
differences, group g decodes on its own (wrapping int32):
``v[g*G + j] = anchor[g] + (j+1)*slope[g] + cumsum(cumsum(s))[j]``.
Group 0 gets a virtual predecessor continuing the series backward at the
first real delta, so s[1] does not carry the whole first delta.
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
    ng = num_groups(n)
    u = dtype_to_u32(values).astype(np.int32, copy=False)  # wrapping arithmetic
    slope0 = np.int32(0)
    if n >= 2:  # array op: silent wrap (scalar ops warn on overflow)
        slope0 = np.subtract(u[1:2], u[0:1])[0]
    d = np.zeros(n, dtype=np.int32)
    if n:
        d[0] = slope0  # the virtual d[0]; s[0] = d[0] - slope0 = 0
        np.subtract(u[1:], u[:-1], out=d[1:])
    s = np.zeros(n, dtype=np.int32)
    if n:
        np.subtract(d[1:], d[:-1], out=s[1:])  # s[0] := 0; s[1] = 0 too
    z = pad_to_groups(zigzag(s))  # pad s entries are 0
    anchors = np.zeros(ng, dtype=np.int32)
    slopes = np.zeros(ng, dtype=np.int32)
    if n:
        anchors[0] = np.subtract(u[0:1], slope0)[0]  # virtual v[-1]
        slopes[0] = slope0
        idx = np.arange(1, ng, dtype=np.int64) * GROUP  # g*G <= n-1 for g < ng
        anchors[1:] = u[idx - 1]
        np.subtract(u[idx - 1], u[idx - 2], out=slopes[1:])  # d[g*G - 1]
    if bits is None:
        bits = bits_needed(int(z.max(initial=0)))
    return EncodedColumn(
        name=name,
        scheme="delta2",
        dtype=str(values.dtype),
        n=n,
        params={"bits": int(bits)},
        streams={"packed": lmp_pack(z, bits), "anchors": anchors, "slopes": slopes},
    )


def decode(col: EncodedColumn) -> np.ndarray:
    bits = col.params["bits"]
    ng = num_groups(col.n)
    z = lmp_unpack(col.streams["packed"], bits, ng * GROUP)
    s = unzigzag(z).reshape(ng, GROUP).astype(np.int64)
    # |s| < 2^31, GROUP = 2^15: |cumsum| < 2^46, |cumsum^2| < 2^61 — exact
    # in int64; wrap to uint32 once at the end (FORMAT §1.17).
    cc = np.cumsum(np.cumsum(s, axis=1), axis=1)
    anchors = col.streams["anchors"].astype(np.int64)
    slopes = col.streams["slopes"].astype(np.int64)
    pos1 = np.arange(1, GROUP + 1, dtype=np.int64)
    u = (anchors[:, None] + slopes[:, None] * pos1 + cc).astype(np.uint32)
    return u32_to_dtype(u.reshape(-1)[: col.n], col.dtype)


registry.register("delta2", encode, decode)
