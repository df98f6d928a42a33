"""Top-k / ORDER BY over compressed columns.

Counterpart of giddy_tpu/topk.py. The column decodes on the card with its
own kernel, its payloads map to monotone int32 keys (kernels/lanes.order_key,
the key space of aggregate.py, so floats follow IEEE total order), and
``torch.topk`` selects k of them there: only k (value, position) pairs
cross back to the host.

Ties: the reference's ``lax.top_k`` returns the lower position first among
equal keys, and ``torch.topk`` promises no order among equal values on
CUDA. So the selection ranks one int64 key, ``(key << 32) | (0xFFFFFFFF -
position)``: every rank is distinct, and equal keys come back lowest
position first. Smallest-k complements the keys (``~key``). Pad rows and
null rows take the key -2^31 before the selection; if a valid row with that
key ties with them and the selection returns a pad or null row, the
selection is redone on the host, exactly. Wide columns select on int64
keys on the card (``_top_k_wide``) in the tie order of the reference's host
selection.
"""

from __future__ import annotations

import numpy as np
import torch

from .format import EncodedColumn
from .util import np_dtype


def top_k(col: EncodedColumn, k: int, *, largest: bool = True, device: torch.device | str = "cuda"):
    """The k largest (or smallest) values and their row positions, sorted
    by rank. Null rows never qualify; if fewer than k rows qualify, the
    result is shorter. Returns (values, positions) as NumPy: values in the
    column's logical dtype, positions int64."""
    from . import nulls
    from .api import _check_supported, _decode_device, device_streams, get_decoder
    from .groupby import _unmap_keys_host, bitmap_rows
    from .kernels import lanes

    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    device = _decode_device(device)
    _check_supported(col)
    if col.scheme == "wide":
        return _top_k_wide(col, k, largest, device)
    nullable = nulls.is_nullable(col)
    k_eff = min(k, nulls.count_valid(col))
    if k_eff == 0:
        return np.empty(0, np_dtype(col.dtype)), np.empty(0, np.int64)
    dt = np_dtype(col.dtype)
    u = get_decoder(col)(device_streams(col, device))
    keys = lanes.order_key(u, dt.kind, dt.itemsize)
    if not largest:
        keys = ~keys  # monotone flip, overflow-free
    pos = torch.arange(u.shape[0], dtype=torch.int64, device=device)
    valid = pos < col.n
    if nullable:
        valid &= bitmap_rows(nulls.valid_words_device(col, device))
    keys = torch.where(valid, keys, -(2**31))
    rank = keys.to(torch.int64) * 2**32 | (0xFFFFFFFF - pos)
    top = torch.topk(rank, k_eff).values.cpu().numpy()
    topv = (top >> 32).astype(np.int32)
    topi = np.int64(0xFFFFFFFF) - (top & np.int64(0xFFFFFFFF))
    # sentinel collision: a returned pad or null row means a valid row
    # with the identity key tied with them; redo on the host, exactly
    bad = topi >= col.n
    if nullable and not bad.any():
        bad = ~nulls.valid_mask(col)[topi]
    if bad.any():
        return _top_k_host(col, k_eff, largest, device)
    if not largest:
        topv = ~topv
    return _unmap_keys_host(topv, col.dtype).astype(dt, copy=False), topi


def _top_k_wide(col: EncodedColumn, k: int, largest: bool, device: torch.device):
    """Top-k of a wide column on ``device``, in the order of the
    reference's host selection (``_top_k_host``: a stable ascending sort of
    the keys, whose last k reversed put equal keys highest position first
    for the largest, and whose first k lowest position first for the
    smallest). ``torch.topk`` finds the k-th key t; the rows beyond t sort
    stably, and the rows equal to t fill the rest in that tie order."""
    from . import nulls, wide
    from .groupby import _wide_keys

    bits = wide.decode_device(col, device=device).view(torch.int64)  # gathered as int64, viewed back on the host
    keys = _wide_keys(bits, np_dtype(col.dtype).kind)
    rows = None
    if nulls.is_nullable(col):
        rows = torch.from_numpy(np.flatnonzero(nulls.valid_mask(col))).to(device)
        keys = keys[rows]
    k_eff = min(k, keys.shape[0])
    if k_eff == 0:
        return np.empty(0, np_dtype(col.dtype)), np.empty(0, np.int64)
    if not largest:
        keys = ~keys  # monotone flip: the smallest become the largest
    t = torch.topk(keys, k_eff).values[-1]
    above = torch.nonzero(keys > t).reshape(-1)
    tied = torch.nonzero(keys == t).reshape(-1)[: k_eff - above.shape[0]] if not largest else \
        torch.nonzero(keys == t).reshape(-1).flip(0)[: k_eff - above.shape[0]]
    if largest:
        above = above.flip(0)  # the stable sort below then keeps equal keys highest position first
    order = torch.sort(keys[above], descending=True, stable=True).indices
    pos = torch.cat([above[order], tied])
    if rows is not None:
        pos = rows[pos]
    return bits[pos].cpu().numpy().view(np_dtype(col.dtype)), pos.cpu().numpy().astype(np.int64)


def _top_k_host(col: EncodedColumn, k: int, largest: bool, device: torch.device):
    """The host selection (sentinel collisions): decode on ``device``, then
    a stable argsort on the zone-map keys."""
    from . import nulls
    from .api import decode
    from .zonemap import _keys

    v = decode(col, device=device).cpu().numpy()
    k_arr = _keys(v, col.dtype)
    if nulls.is_nullable(col):
        m = nulls.valid_mask(col)
        idx_all = np.flatnonzero(m)
        k_arr = k_arr[m]
    else:
        idx_all = np.arange(col.n, dtype=np.int64)
    k_eff = min(k, k_arr.shape[0])
    if k_eff == 0:
        return np.empty(0, v.dtype), np.empty(0, np.int64)
    part = np.argsort(k_arr, kind="stable")
    sel = part[-k_eff:][::-1] if largest else part[:k_eff]
    pos = idx_all[sel]
    return v[pos], pos.astype(np.int64)


def argmax_(col: EncodedColumn, *, device: torch.device | str = "cuda") -> int:
    """Row position of the maximum (total order for floats; null-aware)."""
    return int(top_k(col, 1, largest=True, device=device)[1][0])


def argmin_(col: EncodedColumn, *, device: torch.device | str = "cuda") -> int:
    """Row position of the minimum."""
    return int(top_k(col, 1, largest=False, device=device)[1][0])


def order_by(col: EncodedColumn, *, ascending: bool = True, limit: int | None = None,
             device: torch.device | str = "cuda"):
    """ORDER BY [LIMIT]: sorted (values, positions). With ``limit`` this is
    top_k; without, a decode on ``device`` and a host argsort on the
    monotone keys (the output is as large as the input)."""
    if limit is not None:
        return top_k(col, limit, largest=not ascending, device=device)
    from . import nulls
    from .api import decode
    from .zonemap import _keys

    v = decode(col, device=device).cpu().numpy()
    keys = _keys(v, col.dtype)
    if nulls.is_nullable(col):
        m = nulls.valid_mask(col)
        idx = np.flatnonzero(m)
        order = np.argsort(keys[m], kind="stable")
    else:
        idx = np.arange(col.n, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
    if not ascending:
        order = order[::-1]
    pos = idx[order].astype(np.int64)
    return v[pos], pos
