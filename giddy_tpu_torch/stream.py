"""Streaming decode: overlap host->device feeding with decode on the card.

Counterpart of giddy_tpu/stream.py. A column streams in group chunks
(partial.GroupSlicer keeps every scheme self-contained): each chunk's
streams are staged in pinned host memory and copied ``non_blocking`` on a
copy stream, and the compute stream waits on an event before the chunk's
decode, so chunk k+1 crosses the link while chunk k decodes. The
reference's in-flight windows stay: two decoded chunks ahead of the
consumer, four chunk bitmaps in ``stream_count_where``, so device memory
stays bounded by a few chunks whatever the column's size. Tensors made on
the copy stream are marked used by the compute stream (``record_stream``),
so the caching allocator reuses no buffer that a decode may still read.

Every entry point takes ``device`` (the card unless ``"cpu"`` is asked,
where the uploads are plain copies and nothing overlaps).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .format import EncodedColumn
from .partial import GroupSlicer
from .util import num_groups

DECODE_DEPTH = 2  # decoded chunks in flight beyond the one being consumed
COUNT_DEPTH = 4  # chunk bitmaps in flight in stream_count_where


class _Stager:
    """Chunk uploads for one stream of chunks: on a CUDA device through
    pinned host buffers on a copy stream, elsewhere api.upload."""

    def __init__(self, device: torch.device):
        self.copy = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, streams: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
        if self.copy is None:
            from .api import upload

            return upload(streams, device)
        compute = torch.cuda.current_stream(device)
        out = {}
        with torch.cuda.stream(self.copy):
            for k, v in streams.items():
                v = np.ascontiguousarray(v)
                if v.dtype == np.uint32:
                    v = v.view(np.int32)
                out[k] = torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.copy)
        compute.wait_event(done)
        for t in out.values():
            t.record_stream(compute)
        return out


def stream_decode(
    col: EncodedColumn, *, chunk_groups: int = 64, to_host: bool = False, device: torch.device | str = "cuda"
) -> Iterator[np.ndarray | torch.Tensor]:
    """Yield decoded chunks of ``chunk_groups`` GROUPs each, in order.

    Uploads and decodes are enqueued ahead, so the card decodes chunk k
    while chunk k+1 is still crossing the link. With ``to_host`` the chunks
    come back as NumPy (synchronizing per chunk); otherwise they are
    tensors on ``device``. Wide (64-bit) columns stream their two planes
    and recombine each chunk on the host: their chunks are NumPy always, as
    in the reference."""
    from .api import _decode_device, _to_logical, get_decoder

    device = _decode_device(device)
    if col.scheme == "wide":
        from . import wide

        lo_it = stream_decode(wide._sub(col, "lo"), chunk_groups=chunk_groups, device=device)
        hi_it = stream_decode(wide._sub(col, "hi"), chunk_groups=chunk_groups, device=device)
        for lo, hi in zip(lo_it, hi_it):
            yield wide._combine(lo.cpu().numpy().view(np.uint32), hi.cpu().numpy().view(np.uint32), col.dtype)
        return

    slicer = GroupSlicer(col, device=device)
    stage = _Stager(device)
    ng = num_groups(col.n)
    pending: list[tuple[torch.Tensor, int]] = []
    for c0 in range(0, ng, chunk_groups):
        c1 = min(c0 + chunk_groups, ng)
        sub = slicer.slice(c0, c1)
        if sub.scheme == "_patched_slice":  # the slicer's exception scatter (every chunk of such a column)
            out = slicer.decode(c0, c1)
            yield out if to_host else torch.from_numpy(out).to(device)
            continue
        pending.append((get_decoder(sub)(slicer._streams(sub, stage)), sub.n))  # enqueued
        if len(pending) > DECODE_DEPTH:
            u, n = pending.pop(0)
            yield _emit(_to_logical(u, col.dtype)[:n], to_host)
    for u, n in pending:
        yield _emit(_to_logical(u, col.dtype)[:n], to_host)


def _emit(out: torch.Tensor, to_host: bool):
    return out.cpu().numpy() if to_host else out


def decode_streamed(col: EncodedColumn, *, chunk_groups: int = 64, device: torch.device | str = "cuda") -> np.ndarray:
    """Convenience: stream the whole column back to the host, concatenated."""
    return np.concatenate(list(stream_decode(col, chunk_groups=chunk_groups, to_host=True, device=device)))


def stream_count_where(col: EncodedColumn, op: str, value, *, chunk_groups: int = 64,
                       device: torch.device | str = "cuda") -> int:
    """Predicate count over a column streamed in group chunks: bounded
    device memory whatever the column's size (the larger-than-memory
    scan). Chunks run query.filter_bitmap on their device-form streams (K16
    for nbit/dzbf/for and dict codes); only the chunks' 1-bit match words
    live on the card, at most COUNT_DEPTH of them in flight. Semantics
    match query.count_where, including float total order and the mod-2^32
    staging of out-of-range integer values."""
    from . import nulls
    from .api import _decode_device
    from .kernels.filter_ import OPS
    from .query import count_bits, filter_bitmap, host_cmp_mask
    from .util import GROUP, NP_CMP, dtype_to_u32

    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    device = _decode_device(device)
    ng = num_groups(col.n)
    # nullable chunks carry their validity window (GroupSlicer.slice); the
    # host compares below mask explicitly
    vmask = nulls.valid_mask(col) if nulls.is_nullable(col) else None

    if col.scheme == "wide":
        # the planes recombine on the host anyway: compare the streamed
        # chunks there on total-order keys (query._wide_hits' semantics)
        from .zonemap import _key_scalar, _keys

        vk = _key_scalar(value, col.dtype)
        total = pos = 0
        for chunk in stream_decode(col, chunk_groups=chunk_groups, device=device):
            m = NP_CMP[op](_keys(chunk, col.dtype), vk)
            if vmask is not None:
                m = m & vmask[pos : pos + chunk.shape[0]]
            total += int(m.sum())
            pos += chunk.shape[0]
        return total

    slicer = GroupSlicer(col, device=device)
    stage = _Stager(device)
    pending: list[tuple[torch.Tensor, int]] = []
    total = 0
    for c0 in range(0, ng, chunk_groups):
        c1 = min(c0 + chunk_groups, ng)
        sub = slicer.slice(c0, c1)
        if sub.scheme == "_patched_slice":
            # the slicer's scatter epilogue, then the host compare with the
            # device chunks' staged semantics
            m = host_cmp_mask(dtype_to_u32(slicer.decode(c0, c1)), op, value, col.dtype)
            if vmask is not None:
                m = m & vmask[c0 * GROUP : c0 * GROUP + sub.n]
            total += int(m.sum())
            continue
        bm = filter_bitmap(sub, op, value, device=device, streams=slicer._streams(sub, stage))  # enqueued
        pending.append((bm, sub.n))
        if len(pending) > COUNT_DEPTH:
            total += count_bits(*pending.pop(0))
    for bm, n in pending:
        total += count_bits(bm, n)
    return total
