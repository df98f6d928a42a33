"""Frame-of-reference decode: kernel K2 (csrc/lmp_decode.cu ``for_unpack_kernel``).

Counterpart of giddy_tpu/kernels/for_.py. The frame references are
expanded to one per group on the host (:func:`prep`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, LANES, num_groups
from . import _wrap, lanes

LAUNCHES = 0


def prep(col: EncodedColumn) -> dict:
    """Host prep (giddy_tpu/kernels/for_.py:22-28): one frame reference
    per group, so the kernel adds refs_g[g] to every value of group g."""
    gpf = col.params["frame_len"] // GROUP
    ng = num_groups(col.n)
    refs_g = np.repeat(col.streams["refs"], gpf)[:ng]
    return {"packed": col.streams["packed"], "refs_g": refs_g}


def for_unpack(packed: torch.Tensor, refs_g: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    """LMP unpack plus refs_g[g] (uint32 wrap) -> (ng, GROUP) of out_dtype
    (mapped through ``lut`` when given)."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, out_dtype)
    _wrap.check_side(refs_g, ng, "refs_g", packed.device)
    table = _wrap.lut_args(lut, packed.device)
    if packed.device.type == "cpu":
        return lanes.for_unpack(packed, refs_g, bits, out_dtype, lut)
    out = _wrap.empty_out(ng, out_dtype, packed.device)
    _wrap.launch(
        "gt_for_unpack", packed.device, packed.data_ptr(), refs_g.data_ptr(), out.data_ptr(),
        ng, bits, _wrap.OUT_BYTES[out_dtype], *table,
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`for_unpack` that decode ``col`` (prepped streams)."""
    return streams["packed"], streams["refs_g"], col.params["bits"], out_store


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`for_unpack` on ``args``, for roofline.ops_audit:
    ``for_unpack_kernel<T, LutMode>``, a block of
    1024 threads a group; its only loop is the table's copy (kShared)."""
    a = _wrap.bind(for_unpack, args)
    mode = _wrap.lut_mode(a["lut"])
    return [_wrap.Launch(f"gt::for_unpack_kernel<{_wrap.T_NAME[a['out_dtype']]}, (gt::LutMode){mode}>",
                         a["packed"].shape[0] * LANES, _wrap.lut_trips(a["lut"], mode))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: for_unpack(*args(col, streams, out_store)).reshape(-1)


registry.register_device("for", build, prep, narrow_store=True)
