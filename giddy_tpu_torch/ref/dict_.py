"""Dictionary — host codec (FORMAT.md §1.4; BASELINE configs[2])."""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import bits_needed, dtype_to_u32, sorted_factorize, u32_to_dtype
from .lmp import lmp_pack, lmp_unpack


def encode(
    values: np.ndarray,
    *,
    bits: int | None = None,
    dictionary: np.ndarray | None = None,
    name: str = "col",
) -> EncodedColumn:
    values = np.asarray(values)
    # Floats dedupe in bitpattern space (NaN != NaN breaks unique/
    # searchsorted on the logical values).
    as_work = dtype_to_u32 if values.dtype.kind == "f" else (lambda a: a)
    work = as_work(values)
    if dictionary is None:
        dic_work, codes = sorted_factorize(work)
    else:
        dictionary = np.asarray(dictionary, dtype=values.dtype)
        dic_work = as_work(dictionary)
        sorter = np.argsort(dic_work, kind="stable")
        pos = np.searchsorted(dic_work, work, sorter=sorter)
        codes = sorter[np.minimum(pos, dic_work.shape[0] - 1)]
        if not np.array_equal(dic_work[codes], work):
            raise ValueError("values contain entries missing from dictionary")
    d = int(dic_work.shape[0])
    if bits is None:
        bits = bits_needed(max(d - 1, 0))
    return EncodedColumn(
        name=name,
        scheme="dict",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={
            "bits": int(bits),
            "dict_size": d,
            # auto-built dictionaries are sorted in work space and every
            # entry appears at least once (the reference's scan layer uses
            # both facts)
            "dense": dictionary is None,
        },
        streams={
            "codes": lmp_pack(codes.astype(np.uint32), bits),
            # dic_work is already uint32 for floats; integers zero-extend
            "values": (
                dic_work.view(np.int32)
                if values.dtype.kind == "f"
                else dtype_to_u32(dic_work).astype(np.int32)
            ),
        },
    )


def decode(col: EncodedColumn) -> np.ndarray:
    codes = lmp_unpack(col.streams["codes"], col.params["bits"], col.n)
    u = col.streams["values"].view(np.uint32)[codes]
    return u32_to_dtype(u, col.dtype)


registry.register("dict", encode, decode)
