"""Cascade (dictionary + sub-encoded codes) — host codec (FORMAT.md §1.14).

The port's copy of giddy_tpu/ref/cascade.py: a dictionary maps values to
codes, and the int32 code column is itself encoded with one of
``INNER_SCHEMES`` (``rle`` by default: the RLE_DICTIONARY combination).
Streams: ``values`` (the dictionary) plus the inner column's streams
under a ``c_`` prefix. ``INNER_SCHEMES`` is the code's list, which holds
``delta2`` where FORMAT.md §1.14 does not.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import dtype_to_u32, sorted_factorize, u32_to_dtype

# Inner schemes must decode int32 code columns with no further nesting.
INNER_SCHEMES = ("rle", "rpe", "delta", "delta2", "nbit", "for", "dzbf", "raw")


def codes_column(col: EncodedColumn, streams: dict | None = None) -> EncodedColumn:
    """The nested code column (``c_``-prefixed streams, int32 payload)."""
    if streams is None:
        streams = {k[2:]: v for k, v in col.streams.items() if k.startswith("c_")}
    return EncodedColumn(
        name=f"{col.name}._codes",
        scheme=col.params["codes_scheme"],
        dtype="int32",
        n=col.n,
        params=col.params["codes_params"],
        streams=streams,
    )


def encode(
    values: np.ndarray,
    *,
    codes_scheme: str = "rle",
    dictionary: np.ndarray | None = None,
    name: str = "col",
    **codes_opts,
) -> EncodedColumn:
    if codes_scheme not in INNER_SCHEMES:
        raise ValueError(f"cascade inner scheme must be one of {INNER_SCHEMES}, got {codes_scheme!r}")
    values = np.asarray(values)
    # The dictionary build is ref/dict_'s: floats dedupe in bit-pattern space.
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
    ccol = registry.get(codes_scheme).encode(codes.astype(np.int32), name="_codes", **codes_opts)
    return EncodedColumn(
        name=name,
        scheme="cascade",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={
            "codes_scheme": codes_scheme,
            "codes_params": ccol.params,
            "dict_size": d,
            # auto-built dictionaries are sorted in work space and every
            # entry appears at least once (the reference's scan layer uses
            # both facts)
            "dense": dictionary is None,
        },
        streams={
            "values": (
                dic_work.view(np.int32)
                if values.dtype.kind == "f"
                else dtype_to_u32(dic_work).astype(np.int32)
            ),
            **{f"c_{k}": v for k, v in ccol.streams.items()},
        },
    )


def decode(col: EncodedColumn) -> np.ndarray:
    ccol = codes_column(col)
    codes = registry.get(ccol.scheme).decode_ref(ccol).astype(np.int64)
    u = col.streams["values"].view(np.uint32)[codes]
    return u32_to_dtype(u, col.dtype)


registry.register("cascade", encode, decode)
