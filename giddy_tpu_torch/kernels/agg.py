"""Fused aggregate: kernel K17 (csrc/scan_epilogue.cu ``agg_fold_kernel``).

Counterpart of giddy_tpu/aggregate.py:104 ``_epilogue_agg_call``: the
packed words of an nbit, dzbf or for column go in, (ng, LANES) partials of
the sum, min or max come out (1/32768 of the decoded bytes a partial).
aggregate.py finishes them on the host.
"""

from __future__ import annotations

import torch

from ..util import GROUP, LANES
from . import _wrap, lanes

LAUNCHES = 0
AGGS = ("sum", "min", "max")


def agg_fold(packed: torch.Tensor, refs_g: torch.Tensor | None, valid: torch.Tensor | None, bits: int, n: int, kind: str, itemsize: int, agg: str) -> tuple:
    """(ng, bits*1024) LMP words (+ refs_g[g]) -> the per-(group, lane)
    partials of lanes.slot_fold, (ng, LANES) int32 each: (lo, hi, neg) for
    'sum', (key,) for 'min'/'max'. Positions >= n drop out, and so do rows
    whose bit in ``valid`` (sum only) is 0."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, torch.int32)
    _wrap.check_scan(kind, itemsize, refs_g, valid, ng, packed.device)
    if agg not in AGGS:
        raise ValueError(f"agg must be one of {AGGS}, got {agg!r}")
    if valid is not None and agg != "sum":
        raise ValueError("validity words drop null rows from a sum only (min/max read the canonical fill)")
    if not isinstance(n, int) or not 0 <= n <= ng * GROUP:
        raise ValueError(f"n must be an int in [0, {ng * GROUP}], got {n!r}")
    if packed.device.type == "cpu":
        return lanes.agg_fold(packed, refs_g, valid, bits, n, kind, itemsize, agg)
    outs = tuple(torch.empty((ng, LANES), dtype=torch.int32, device=packed.device) for _ in range(3 if agg == "sum" else 1))
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    _wrap.launch(
        "gt_agg_fold", packed.device, packed.data_ptr(), _wrap.ptr(refs_g), _wrap.ptr(valid), *ptrs,
        ng, bits, n, _wrap.SCAN_KINDS.index(kind), itemsize, AGGS.index(agg), *_wrap.walk_args(packed, valid, bits),
    )
    LAUNCHES += 1
    return outs


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`agg_fold` on ``args``, for roofline.ops_audit:
    ``agg_fold_kernel<Kind, Agg>``, as filter_.census; the float min and
    max keep their mbarrier wait's loop in the tile loop."""
    a = _wrap.bind(agg_fold, args)
    kind = _wrap.SCAN_KINDS.index(a["kind"])
    return [_wrap.scan_launch(f"gt::agg_fold_kernel<(gt::Kind){kind}, (gt::Agg){AGGS.index(a['agg'])}>",
                              a["packed"], a["valid"], a["bits"], a["kind"], a["itemsize"],
                              inline_wait=a["kind"] == "f" and a["agg"] != "sum")]
