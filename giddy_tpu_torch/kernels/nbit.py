"""NBit / dzbf decode: kernel K1 (csrc/lmp_decode.cu ``lmp_unpack_kernel``).

Counterpart of giddy_tpu/kernels/nbit.py; dzbf is LMP(8·width).
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..util import LANES
from . import _wrap, lanes

LAUNCHES = 0


def lmp_unpack(packed: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    """(ng, bits*1024) int32 LMP words -> (ng, GROUP) values of out_dtype
    (mapped through ``lut`` when given)."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, out_dtype)
    table = _wrap.lut_args(lut, packed.device)
    if packed.device.type == "cpu":
        return lanes.lmp_unpack(packed, bits, out_dtype, lut)
    out = _wrap.empty_out(ng, out_dtype, packed.device)
    _wrap.launch(
        "gt_lmp_unpack", packed.device, packed.data_ptr(), out.data_ptr(), ng, bits,
        _wrap.OUT_BYTES[out_dtype], *table,
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`lmp_unpack` that decode ``col``."""
    bits = col.params["bits"] if col.scheme == "nbit" else 8 * col.params["width"]
    return streams["packed"], bits, out_store


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`lmp_unpack` on ``args``, for roofline.ops_audit:
    ``lmp_unpack_kernel<T, LutMode>``, a block of
    1024 threads a group; its only loop is the table's copy (kShared)."""
    a = _wrap.bind(lmp_unpack, args)
    mode = _wrap.lut_mode(a["lut"])
    return [_wrap.Launch(f"gt::lmp_unpack_kernel<{_wrap.T_NAME[a['out_dtype']]}, (gt::LutMode){mode}>",
                         a["packed"].shape[0] * LANES, _wrap.lut_trips(a["lut"], mode))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: lmp_unpack(*args(col, streams, out_store)).reshape(-1)


registry.register_device("nbit", build, narrow_store=True)
registry.register_device("dzbf", build, narrow_store=True)
