"""Lane-major packed-group (LMP) layout — host implementation (FORMAT.md §0.1).

The port's copy of giddy_tpu/ref/lmp.py: the packer behind every
bit-packed stream and the oracle of the unpack kernels. Where the C++ host
codec is built (native.py) both run there; the NumPy code below is
normative and the fallback.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..util import GROUP, LANES, SLOTS, U32, num_groups, pad_to_groups


def lmp_pack(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack unsigned values (any int dtype, each < 2**bits) into LMP words.

    Returns uint32 array of shape (num_groups, bits * LANES).
    """
    if not (1 <= bits <= 32):
        raise ValueError(f"bits must be in [1,32], got {bits}")
    v = pad_to_groups(np.asarray(values))
    # 32-bit integers reinterpret as their uint32 bits, as astype would give them
    v = v.view(np.uint32) if v.dtype.kind in "iu" and v.dtype.itemsize == 4 else v.astype(np.uint32)
    if bits < 32 and int(v.max()) >> bits:
        raise ValueError(f"value out of range for {bits}-bit packing")
    ng = num_groups(v.shape[0])
    nat = native.lmp_pack(v, bits, ng)
    if nat is not None:
        return nat
    # (ng, SLOTS, LANES): slot i of lane c of group g = v[g*GROUP + i*LANES + c]
    v = v.reshape(ng, SLOTS, LANES)
    words = np.zeros((ng, bits, LANES), dtype=np.uint32)
    for i in range(SLOTS):
        bit = i * bits
        w0, s = divmod(bit, 32)
        words[:, w0] |= (v[:, i] << U32(s)) & U32(0xFFFFFFFF)
        if s + bits > 32:
            words[:, w0 + 1] |= v[:, i] >> U32(32 - s)
    return words.reshape(ng, bits * LANES)


def lmp_unpack(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`lmp_pack`; returns uint32 array of length n."""
    if not (1 <= bits <= 32):
        raise ValueError(f"bits must be in [1,32], got {bits}")
    ng = num_groups(n)
    nat = native.lmp_unpack(packed, bits, ng)
    if nat is not None:
        return nat[:n]
    words = np.asarray(packed, dtype=np.uint32).reshape(ng, bits, LANES)
    mask = U32(0xFFFFFFFF) if bits == 32 else U32((1 << bits) - 1)
    out = np.empty((ng, SLOTS, LANES), dtype=np.uint32)
    for i in range(SLOTS):
        bit = i * bits
        w0, s = divmod(bit, 32)
        v = words[:, w0] >> U32(s)
        if s + bits > 32:
            v = v | (words[:, w0 + 1] << U32(32 - s))
        out[:, i] = v & mask
    return out.reshape(ng * GROUP)[:n]
