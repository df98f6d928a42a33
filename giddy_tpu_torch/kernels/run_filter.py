"""Run-table filter: kernel K19 (csrc/scan_epilogue.cu ``run_filter_kernel``).

The predicate of an rle or rpe column evaluated on its tile-form run
tables (kernels/rle.py, K5's input): each run's value is compared once and
an LMP(1) bitmap of the predicate comes out; the decoded column never
exists. It replaces the general path's decode (K5), compare and
``lanes.pack_hits`` for those columns; the reference has no such kernel
and takes its general path (giddy_tpu/query.py:310-320). query.py stages
the comparison value and calls :func:`run_filter`.
"""

from __future__ import annotations

import torch

from ..util import GROUP, LANES
from . import _wrap, lanes, rle
from .filter_ import OPS

LAUNCHES = 0
WARPS = 8  # a block's; a warp takes a quarter group (csrc/scan_epilogue.cu kRunFilterWarps)


def _tiles(ends_w: torch.Tensor, vals_w: torch.Tensor, ng: int) -> int:
    """Validate tile-form run tables over ``ng`` groups (K5's: T = rows / ng
    a power of two <= rle.MAX_TILES, w_pad a power of two <= CHAIN_HARD);
    returns T."""
    rows = _wrap.check_rows(ends_w, "ends_w")
    w_pad = ends_w.shape[1]
    _wrap.check_rows(vals_w, "vals_w", w_pad)
    if vals_w.shape[0] != rows or vals_w.device != ends_w.device:
        raise ValueError(f"vals_w {tuple(vals_w.shape)} on {vals_w.device} does not match "
                         f"ends_w {tuple(ends_w.shape)} on {ends_w.device}")
    tiles = rows // ng if isinstance(ng, int) and ng >= 1 and rows % ng == 0 else 0
    if tiles < 1 or tiles > rle.MAX_TILES or tiles & (tiles - 1) or w_pad & (w_pad - 1) or w_pad > rle.CHAIN_HARD:
        raise ValueError(f"no run-filter kernel for {rows} tables of {w_pad} runs over {ng} groups: "
                         f"wants T = rows/ng a power of two <= {rle.MAX_TILES} and w_pad a power of two "
                         f"<= {rle.CHAIN_HARD}")
    return tiles


def run_filter(ends_w: torch.Tensor, vals_w: torch.Tensor, valid: torch.Tensor | None, ng: int, kind: str, itemsize: int, op: str, key: int) -> torch.Tensor:
    """Tile-form run tables (ng*T, w_pad) int32 -> (ng, LANES) int32 words:
    bit i of word [g, c] = order_key(value at g*GROUP + i*LANES + c) <op>
    key, the value being K5's (lanes.run_expand), pad positions too, ANDed
    with the validity words when given. ``kind``/``itemsize`` are the
    logical dtype's and ``key`` the staged comparison value's order key, as
    in filter_.filter_fold."""
    global LAUNCHES
    tiles = _tiles(ends_w, vals_w, ng)
    _wrap.check_scan(kind, itemsize, None, valid, ng, ends_w.device)
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if not isinstance(key, int) or not -(2**31) <= key < 2**31:
        raise ValueError(f"key must be an int32, got {key!r}")
    if ends_w.device.type == "cpu":
        return lanes.run_filter(ends_w, vals_w, valid, ng, kind, itemsize, op, key)
    out = torch.empty((ng, LANES), dtype=torch.int32, device=ends_w.device)
    _wrap.launch(
        "gt_run_filter", ends_w.device, ends_w.data_ptr(), vals_w.data_ptr(), _wrap.ptr(valid), out.data_ptr(),
        ng, (GROUP // tiles).bit_length() - 1, ends_w.shape[1], _wrap.SCAN_KINDS.index(kind), itemsize,
        OPS.index(op), key,
    )
    LAUNCHES += 1
    return out


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`run_filter` on ``args``, for roofline.ops_audit:
    ``run_filter_kernel<Kind, Op>`` on blocks of WARPS warps, a warp a
    quarter group. Its loops: the tiles a warp visits (T, or the 32 of its
    half of the lanes at W = 512; a block's spare warps none), then in a
    tile the flips XORed in, or the slots and, in each, the rounds of 32
    flips marked in its windows, whose trips are data."""
    a = _wrap.bind(run_filter, args)
    ng, tiles = a["ng"], a["ends_w"].shape[0] // a["ng"]
    blocks = -(-4 * ng // WARPS)
    visits = 32 if tiles == 64 else tiles
    kernel = f"gt::run_filter_kernel<(gt::Kind){_wrap.SCAN_KINDS.index(a['kind'])}, (gt::Op){OPS.index(a['op'])}>"
    return [_wrap.Launch(kernel, blocks * WARPS * 32, (visits * 4 * ng / (blocks * WARPS), None, None, None))]
