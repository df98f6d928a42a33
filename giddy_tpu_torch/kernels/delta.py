"""Delta decode: kernel K3 (csrc/lmp_decode.cu ``delta_decode_kernel``).

Counterpart of giddy_tpu/kernels/delta.py: unpack, unzigzag, inclusive
per-GROUP cumsum (mod 2^32) plus the group's anchor.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..util import LANES
from . import _wrap, lanes

LAUNCHES = 0


def delta_decode(packed: torch.Tensor, anchors: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    """(ng, bits*1024) zigzag deltas + (ng,) anchors -> (ng, GROUP) of
    out_dtype (mapped through ``lut`` when given)."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, out_dtype)
    _wrap.check_side(anchors, ng, "anchors", packed.device)
    table = _wrap.lut_args(lut, packed.device)
    if packed.device.type == "cpu":
        return lanes.delta_decode(packed, anchors, bits, out_dtype, lut)
    out = _wrap.empty_out(ng, out_dtype, packed.device)
    _wrap.launch(
        "gt_delta_decode", packed.device, packed.data_ptr(), anchors.data_ptr(), out.data_ptr(),
        ng, bits, _wrap.OUT_BYTES[out_dtype], *table,
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`delta_decode` that decode ``col``."""
    return streams["packed"], streams["anchors"], col.params["bits"], out_store


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`delta_decode` on ``args``, for roofline.ops_audit:
    ``delta_decode_kernel<T, LutMode>``, a block of
    1024 threads a group: the table's copy (kShared; the kernel's 64 words
    of warp totals share the block's memory with it), then the 32 slots'
    loop, which the compiler keeps rolled two slots a turn."""
    a = _wrap.bind(delta_decode, args)
    mode = _wrap.lut_mode(a["lut"], static_words=64)
    return [_wrap.Launch(f"gt::delta_decode_kernel<{_wrap.T_NAME[a['out_dtype']]}, (gt::LutMode){mode}>",
                         a["packed"].shape[0] * LANES, (*_wrap.lut_trips(a["lut"], mode), 16))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: delta_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("delta", build, narrow_store=True)
