"""Key-column code access of the GROUP BY layer (first pieces of the
counterpart of giddy_tpu/groupby.py).

A dictionary-backed column (dict or cascade) is scanned through its codes:
the value gather never runs. ``_codes_device_column`` gives the int32 code
column that the dict-domain filter pushdown (query.py) and the code counts
of aggregate.py decode. ``group_reduce`` and the rest of the reference's
module are ROADMAP.md queue 1, item 5; strdict keys, item 4.
"""

from __future__ import annotations

import numpy as np

from .format import EncodedColumn
from .util import u32_to_dtype


def _codes_device_column(keys: EncodedColumn) -> EncodedColumn:
    """An int32 column decoding to the key codes, memoized on the parent
    so repeated scans reuse one object (giddy_tpu/groupby.py:53-62)."""
    cached = keys.__dict__.get("_codes_col")
    if cached is None:
        cached = keys._codes_col = _build_codes_column(keys)
    return cached


def _build_codes_column(keys: EncodedColumn) -> EncodedColumn:
    if keys.scheme == "strdict":
        raise NotImplementedError(
            "strdict key columns are not ported to giddy_tpu_torch yet (ROADMAP.md queue 1, item 4)"
        )
    if keys.scheme == "cascade":
        from .ref.cascade import codes_column

        return codes_column(keys)
    if keys.scheme == "dict":
        return EncodedColumn(
            name=f"{keys.name}._codes",
            scheme="nbit",
            dtype="int32",
            n=keys.n,
            params={"bits": keys.params["bits"]},
            streams={"packed": keys.streams["codes"]},
        )
    raise ValueError(
        f"group keys must be a 'dict', 'cascade' or 'strdict' column, got {keys.scheme!r}"
        " (encode the key column with gtt.encode(v, 'cascade'))"
    )


def key_values(keys: EncodedColumn) -> np.ndarray:
    """The dictionary (code -> key value), logical dtype, length d."""
    if keys.scheme == "strdict":
        raise NotImplementedError(
            "strdict key columns are not ported to giddy_tpu_torch yet (ROADMAP.md queue 1, item 4)"
        )
    return u32_to_dtype(keys.streams["values"].view(np.uint32), keys.dtype)
