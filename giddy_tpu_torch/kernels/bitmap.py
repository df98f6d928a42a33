"""Incidence-bitmap decode: kernel K11 (csrc/epilogue_decode.cu ``bitmap_decode_kernel``).

Counterpart of giddy_tpu/kernels/bitmap.py. No host prep. One kernel for
every d >= 1: the reference's switch to an XLA loop above d = 64 is a VMEM
limit of the TPU and has no counterpart here. An empty column (d = 0)
decodes to zeros and launches nothing (:func:`build`).
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, LANES, num_groups
from . import _wrap, lanes

LAUNCHES = 0


def bitmap_decode(bitmaps: torch.Tensor, values: torch.Tensor, ng: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(d, ng*1024) LMP(1) planes + (d,) values, d >= 1 -> (ng, GROUP) of
    out_dtype, the sum over the planes of bit · values[d] (mod 2^32)."""
    global LAUNCHES
    _wrap.check_out_dtype(out_dtype)
    if not isinstance(ng, int) or ng < 1:
        raise ValueError(f"ng must be an int >= 1, got {ng!r}")
    d = _wrap.check_rows(bitmaps, "bitmaps", ng * LANES)
    _wrap.check_side(values, d, "values", bitmaps.device)
    if bitmaps.device.type == "cpu":
        return lanes.bitmap_decode(bitmaps, values, ng, out_dtype)
    out = _wrap.empty_out(ng, out_dtype, bitmaps.device)
    _wrap.launch(
        "gt_bitmap_decode", bitmaps.device, bitmaps.data_ptr(), values.data_ptr(), out.data_ptr(),
        ng, d, _wrap.OUT_BYTES[out_dtype],
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`bitmap_decode` that decode ``col`` (the
    planes as (d, ng*1024) rows, whether they come flat or, from a
    partial-decode slice, as (d, ng, 1024))."""
    values = streams["values"]
    return streams["bitmaps"].reshape(values.shape[0], -1), values, num_groups(col.n), out_store



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`bitmap_decode` on ``args``, for
    roofline.ops_audit: ``bitmap_decode_kernel<T>``, a block of 1024
    threads a group, its loop over the d planes unrolled by 4
    (``#pragma unroll 4``, csrc/epilogue_decode.cu): d // 4 turns of the
    unrolled body, then d % 4 of the remainder loop."""
    a = _wrap.bind(bitmap_decode, args)
    d = a["values"].shape[0]
    return [_wrap.Launch(f"gt::bitmap_decode_kernel<{_wrap.T_NAME[a['out_dtype']]}>", a["ng"] * LANES, (d // 4, d % 4))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    if col.params["d"] == 0:
        # empty column: no planes; the padded output is zeros, as the
        # reference returns it (bitmap.py:29-30), and no kernel runs
        def empty(streams):
            return torch.zeros(num_groups(col.n) * GROUP, dtype=out_store, device=streams["values"].device)

        return empty

    return lambda streams: bitmap_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("bitmap", build, narrow_store=True)
