"""Nullable columns: validity bitmaps and the canonical null fill.

Counterpart of giddy_tpu/nulls.py (FORMAT.md §0.3). A nullable column sets
``params["nullable"]`` and carries a ``valid`` stream: (ng, LANES) uint32
words in the LMP(1) layout of the filter bitmaps (bit i of word [g, c] =
row ``g*GROUP + i*LANES + c`` is non-null; pad rows are 0). Null slots
hold the canonical fill (the previous valid value; back-fill for leading
nulls; 0 when every row is null), so decode returns filled values and
min/max/distinct over the filled column equal those over the valid rows.
Predicates AND the validity words in (query.py); sums skip null rows
inside the fused fold (aggregate.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .format import EncodedColumn
from .ref.lmp import lmp_pack, lmp_unpack
from .util import LANES, num_groups


def pack_valid(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> (ng, LANES) uint32 LMP(1) words (pad bits 0)."""
    mask = np.asarray(mask)
    if mask.dtype != np.bool_:
        raise TypeError(f"valid mask must be boolean, got {mask.dtype}")
    return lmp_pack(mask.astype(np.uint32), 1)


def unpack_valid(words: np.ndarray, n: int) -> np.ndarray:
    """(ng, LANES) uint32 words -> bool[n]."""
    return lmp_unpack(np.asarray(words).reshape(num_groups(n), LANES), 1, n).astype(bool)


def fill_nulls(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The canonical null fill: forward-fill from the previous valid value,
    back-fill leading nulls from the first valid value, 0 if all-null."""
    values = np.asarray(values)
    mask = np.asarray(mask, bool)
    if values.shape != mask.shape:
        raise ValueError(f"values/mask shape mismatch: {values.shape} vs {mask.shape}")
    if mask.all():
        return values
    if not mask.any():
        return np.zeros_like(values)
    idx = np.where(mask, np.arange(values.shape[0]), 0)
    np.maximum.accumulate(idx, out=idx)
    first = int(np.flatnonzero(mask)[0])
    idx[:first] = first  # back-fill the leading-null prefix
    return values[idx]


def is_nullable(col: EncodedColumn) -> bool:
    return bool(col.params.get("nullable")) and "valid" in col.streams


def valid_mask(col: EncodedColumn) -> np.ndarray:
    """bool[n] validity of each row (all-True for non-nullable columns)."""
    if not is_nullable(col):
        return np.ones(col.n, bool)
    return unpack_valid(col.streams["valid"], col.n)


def valid_words_device(col: EncodedColumn, device: torch.device | str = "cuda") -> torch.Tensor:
    """The (ng, LANES) validity words on ``device`` as int32 (uint32 bits),
    uploaded once per column and device: cached on the column, whose
    streams are immutable by contract; :func:`attach_valid` drops it."""
    device = torch.device(device)
    cache = col.__dict__.setdefault("_valid_dev", {})
    words = cache.get(device)
    if words is None:
        words = cache[device] = torch.from_numpy(np.ascontiguousarray(col.streams["valid"]).view(np.int32)).to(device)
    return words


def null_count(col: EncodedColumn) -> int:
    if not is_nullable(col):
        return 0
    # pad bits are 0 in the valid stream, so popcount is exact (unpackbits:
    # np.bitwise_count needs NumPy 2)
    words = np.ascontiguousarray(col.streams["valid"], dtype=np.uint32)
    return col.n - int(np.unpackbits(words.view(np.uint8)).sum())


def count_valid(col: EncodedColumn) -> int:
    """Number of non-null rows (SQL COUNT(col))."""
    return col.n - null_count(col)


def attach_valid(col: EncodedColumn, mask: np.ndarray) -> EncodedColumn:
    """Mark an encoded column nullable (mask: bool[n], True = non-null).
    Mutates and returns ``col``. The caller is responsible for having
    encoded canonically filled values (api.encode does both)."""
    mask = np.asarray(mask, bool)
    if mask.shape != (col.n,):
        raise ValueError(f"valid mask must have shape ({col.n},), got {mask.shape}")
    col.streams = dict(col.streams)
    col.streams["valid"] = pack_valid(mask)
    col.params = {**col.params, "nullable": True}
    # a re-attached mask must not be shadowed by the words uploaded before
    col.__dict__.pop("_valid_dev", None)
    return col


def decode_masked(col: EncodedColumn, *, device: torch.device | str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Decode on ``device`` -> (values[n], valid[n] bool), both on
    ``device``. Values at null rows hold the canonical fill."""
    from .api import decode

    values = decode(col, device=device)
    return values, torch.from_numpy(valid_mask(col)).to(values.device)


def notnull_bitmap(col: EncodedColumn, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """(ng, LANES) LMP(1) bitmap of non-null rows on ``device`` (composable
    with the query.py bitmap algebra; pad bits are 0)."""
    if not is_nullable(col):
        from .query import _mask_pad

        return _mask_pad(torch.full((num_groups(col.n), LANES), -1, dtype=torch.int32, device=device), col.n)
    return valid_words_device(col, device)


def isnull_bitmap(col: EncodedColumn, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """(ng, LANES) LMP(1) bitmap of null rows on ``device``."""
    from .query import bitmap_not

    return bitmap_not(notnull_bitmap(col, device=device), col.n)


def null_positions(col: EncodedColumn) -> np.ndarray:
    """Row indices of the null rows (host, int64)."""
    if not is_nullable(col):
        return np.empty(0, np.int64)
    return np.flatnonzero(~valid_mask(col)).astype(np.int64)
