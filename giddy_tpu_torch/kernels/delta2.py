"""Delta-of-delta decode: kernel K7 (csrc/run_decode.cu ``delta2_decode_kernel``).

Counterpart of giddy_tpu/kernels/delta2.py: unpack, unzigzag, two
inclusive per-GROUP cumsums, then anchor[g] + slope[g]·(j+1), mod 2^32.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from . import _wrap, lanes

LAUNCHES = 0


def delta2_decode(packed: torch.Tensor, anchors: torch.Tensor, slopes: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    """(ng, bits*1024) zigzag second differences + (ng,) anchors and slopes
    -> (ng, GROUP) of out_dtype (mapped through ``lut`` when given)."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, out_dtype)
    _wrap.check_side(anchors, ng, "anchors", packed.device)
    _wrap.check_side(slopes, ng, "slopes", packed.device)
    table = _wrap.lut_args(lut, packed.device)
    if packed.device.type == "cpu":
        return lanes.delta2_decode(packed, anchors, slopes, bits, out_dtype, lut)
    out = _wrap.empty_out(ng, out_dtype, packed.device)
    _wrap.launch(
        "gt_delta2_decode", packed.device, packed.data_ptr(), anchors.data_ptr(), slopes.data_ptr(),
        out.data_ptr(), ng, bits, _wrap.OUT_BYTES[out_dtype], *table,
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`delta2_decode` that decode ``col``."""
    return streams["packed"], streams["anchors"], streams["slopes"], col.params["bits"], out_store


def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: delta2_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("delta2", build, narrow_store=True)
