"""XOR-delta decode: kernel K8 (csrc/run_decode.cu ``xordelta_decode_kernel``).

Counterpart of giddy_tpu/kernels/xordelta.py: unpack, per-group inclusive
prefix XOR, XOR the anchor. As in the reference, it has no narrow store:
it always writes the uint32 payload, and narrow columns are cut after.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..util import LANES
from . import _wrap, lanes

LAUNCHES = 0


def xordelta_decode(packed: torch.Tensor, anchors: torch.Tensor, bits: int) -> torch.Tensor:
    """(ng, bits*1024) XOR stream + (ng,) anchors -> (ng, GROUP) int32 payloads."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, torch.int32)
    _wrap.check_side(anchors, ng, "anchors", packed.device)
    if packed.device.type == "cpu":
        return lanes.xordelta_decode(packed, anchors, bits)
    out = _wrap.empty_out(ng, torch.int32, packed.device)
    _wrap.launch("gt_xordelta_decode", packed.device, packed.data_ptr(), anchors.data_ptr(), out.data_ptr(), ng, bits)
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`xordelta_decode` that decode ``col``
    (``out_store`` is always int32 here: no narrow store)."""
    return streams["packed"], streams["anchors"], col.params["bits"]



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`xordelta_decode` on ``args``, for
    roofline.ops_audit: ``xordelta_decode_kernel``, a block of 1024 threads
    a group, its 32 slots' loop rolled two slots a turn."""
    packed = _wrap.bind(xordelta_decode, args)["packed"]
    return [_wrap.Launch("gt::xordelta_decode_kernel", packed.shape[0] * LANES, (16,))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: xordelta_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("xordelta", build)
