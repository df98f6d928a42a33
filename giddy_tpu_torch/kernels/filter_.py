"""Fused filter: kernel K16 (csrc/scan_epilogue.cu ``filter_fold_kernel``).

Counterpart of giddy_tpu/query.py:72 ``_epilogue_filter_call``: the
packed words of an nbit, dzbf or for column go in, an LMP(1) bitmap of
the predicate comes out; the decoded column never exists. query.py stages
the comparison value and calls :func:`filter_fold`.
"""

from __future__ import annotations

import torch

from ..util import LANES
from . import _wrap, lanes

LAUNCHES = 0
OPS = ("eq", "ne", "lt", "le", "gt", "ge")


def filter_fold(packed: torch.Tensor, refs_g: torch.Tensor | None, valid: torch.Tensor | None, bits: int, kind: str, itemsize: int, op: str, key: int) -> torch.Tensor:
    """(ng, bits*1024) LMP words (+ refs_g[g]) -> (ng, LANES) int32 words:
    bit i of word [g, c] = order_key(value at g*GROUP + i*LANES + c) <op>
    key, ANDed with the validity words when given. ``kind``/``itemsize``
    are the logical dtype's (lanes.order_key); ``key`` is the staged
    comparison value's order key, an int32."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, torch.int32)
    _wrap.check_scan(kind, itemsize, refs_g, valid, ng, packed.device)
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if not isinstance(key, int) or not -(2**31) <= key < 2**31:
        raise ValueError(f"key must be an int32, got {key!r}")
    if packed.device.type == "cpu":
        return lanes.filter_fold(packed, refs_g, valid, bits, kind, itemsize, op, key)
    out = torch.empty((ng, LANES), dtype=torch.int32, device=packed.device)
    _wrap.launch(
        "gt_filter_fold", packed.device, packed.data_ptr(), _wrap.ptr(refs_g), _wrap.ptr(valid), out.data_ptr(),
        ng, bits, _wrap.SCAN_KINDS.index(kind), itemsize, OPS.index(op), key, *_wrap.walk_args(packed, valid, bits),
    )
    LAUNCHES += 1
    return out


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`filter_fold` on ``args``, for
    roofline.ops_audit: ``filter_fold_kernel<Kind, Op>`` on a grid of
    blocks of 256 threads (_wrap.walk_args), whose loops are walk_tiles'
    (_wrap.walk_trips); a signed kind has a copy for the narrow widths and
    one for 32 bits (by_width), and only the one the itemsize picks runs."""
    a = _wrap.bind(filter_fold, args)
    kind = _wrap.SCAN_KINDS.index(a["kind"])
    return [_wrap.scan_launch(f"gt::filter_fold_kernel<(gt::Kind){kind}, (gt::Op){OPS.index(a['op'])}>",
                              a["packed"], a["valid"], a["bits"], a["kind"], a["itemsize"])]
