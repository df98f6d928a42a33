"""ALP decimal-float decode: kernel K12 (csrc/epilogue_decode.cu ``alp_decode_kernel``).

Counterpart of giddy_tpu/kernels/alp.py: unpack + per-group ref, int32 ->
float32, times f32(10^-e), the bits plus the unzigzagged correction, then
the exceptions written over it, in one launch. The only float operations
are a correctly rounded convert and multiply; f32(10^-e) comes from the
host as its bits (``scale_bits``), computed as the encoder computes it. alp
columns are float32, so the store is always 32 bits.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..ref import alp as ref_alp
from ..util import LANES
from . import _wrap, lanes

LAUNCHES = 0


def prep(col: EncodedColumn) -> dict:
    """Host prep (giddy_tpu/kernels/alp.py:31-37): ``refs`` becomes
    ``refs_g`` ((ng,) here, (ng, 1) in the reference: the same bytes);
    streams already in that form pass through."""
    if "refs_g" in col.streams:
        return col.streams
    s = dict(col.streams)
    s["refs_g"] = s.pop("refs")
    return s


def alp_decode(packed: torch.Tensor, corr: torch.Tensor, refs_g: torch.Tensor, patch_pos: torch.Tensor, patch_val: torch.Tensor, bits: int, corr_bits: int, scale_bits: int, count: int) -> torch.Tensor:
    """(ng, bits*1024) offset words, (ng, corr_bits*1024) correction words,
    (ng,) refs_g and the ``count`` exceptions (patch_pos ascending,
    patch_val) -> (ng, GROUP) int32 carrying the float32 bits."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, torch.int32)
    _wrap.check_packed(corr, corr_bits, torch.int32)
    if corr.shape[0] != ng:
        raise ValueError(f"corr has {corr.shape[0]} groups, the packed words {ng}")
    _wrap.check_side(refs_g, ng, "refs_g", packed.device)
    if corr.device != packed.device:
        raise ValueError(f"corr is on {corr.device}, the packed words on {packed.device}")
    if _wrap.check_exceptions(patch_pos, patch_val, packed.device) != count:
        raise ValueError(f"count is {count}, but {patch_pos.shape[0]} exceptions were given")
    if not isinstance(scale_bits, int) or not 0 <= scale_bits < 2**32:
        raise ValueError(f"scale_bits must be a uint32 bit pattern, got {scale_bits!r}")
    if packed.device.type == "cpu":
        return lanes.alp_decode(packed, corr, refs_g, patch_pos, patch_val, bits, corr_bits, scale_bits, count)
    out = _wrap.empty_out(ng, torch.int32, packed.device)
    _wrap.launch(
        "gt_alp_decode", packed.device, packed.data_ptr(), corr.data_ptr(), refs_g.data_ptr(),
        patch_pos.data_ptr(), patch_val.data_ptr(), out.data_ptr(), ng, bits, corr_bits, scale_bits, count,
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`alp_decode` that decode ``col`` (prepped
    streams; float32 only, so ``out_store`` is always int32)."""
    p = col.params
    return (streams["packed"], streams["corr"], streams["refs_g"].reshape(-1), streams["patch_pos"],
            streams["patch_val"], p["bits"], p["corr_bits"], ref_alp.scale_bits(p["exp_e"]), p["count"])



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`alp_decode` on ``args``, for roofline.ops_audit:
    ``alp_decode_kernel``, a block of 1024 threads a group, whose loops
    are the exception phase's (_wrap.exception_trips)."""
    a = _wrap.bind(alp_decode, args)
    ng = a["packed"].shape[0]
    return [_wrap.Launch("gt::alp_decode_kernel", ng * LANES, _wrap.exception_trips(a["count"], ng))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: alp_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("alp", build, prep)
