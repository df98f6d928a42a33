"""Identity scheme for incompressible columns — host codec (FORMAT.md §1.12).

The port's copy of giddy_tpu/ref/raw.py: ``data`` is the uint32 payload as
int32, padded to whole groups.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import dtype_to_u32, pad_to_groups, u32_to_dtype


def encode(values: np.ndarray, *, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    return EncodedColumn(
        name=name,
        scheme="raw",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={},
        streams={"data": pad_to_groups(dtype_to_u32(values)).view(np.int32)},
    )


def decode(col: EncodedColumn) -> np.ndarray:
    return u32_to_dtype(col.streams["data"].view(np.uint32)[: col.n], col.dtype)


registry.register("raw", encode, decode)
