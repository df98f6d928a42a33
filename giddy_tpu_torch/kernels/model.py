"""Per-frame model decode: kernel K10 (csrc/epilogue_decode.cu ``model_decode_kernel``).

Counterpart of giddy_tpu/kernels/model.py. The frame's polynomial is
shifted to each group's start on the host (:func:`prep`), so the kernel
evaluates a_g + b_g·p (+ c_g·p²) for the position p within the group and
adds the unzigzagged residual, all mod 2^32.
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
    """Host prep (giddy_tpu/kernels/model.py:25-48): per group g starting at
    p0 within frame f, a_g = a + b·p0 + c·p0², b_g = b + 2·c·p0 and c_g = c,
    in int64 and masked to 32 bits; streams already in that form (they hold
    ``a_g``) pass through. The coefficients are (ng,) here, (ng, 1) in the
    reference: the same bytes."""
    if "a_g" in col.streams:
        return col.streams
    frame_len = col.params["frame_len"]
    ng = num_groups(col.n)
    g = np.arange(ng, dtype=np.int64)
    f = (g * GROUP) // frame_len
    p0 = (g * GROUP) % frame_len
    a = col.streams["coef_a"].astype(np.int64)[f]
    b = col.streams["coef_b"].astype(np.int64)[f]
    poly2 = col.params.get("kind") == "poly2"
    c = col.streams["coef_c"].astype(np.int64)[f] if poly2 else np.int64(0)
    out = {
        "packed": col.streams["packed"],
        "a_g": ((a + b * p0 + c * p0 * p0) & 0xFFFFFFFF).astype(np.uint32),
        "b_g": ((b + 2 * c * p0) & 0xFFFFFFFF).astype(np.uint32),
    }
    if poly2:
        out["c_g"] = (c & 0xFFFFFFFF).astype(np.uint32)
    return out


def model_decode(packed: torch.Tensor, a_g: torch.Tensor, b_g: torch.Tensor, c_g: torch.Tensor | None, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(ng, bits*1024) residual words + (ng,) a_g, b_g (+ c_g for poly2, None
    for linear) -> (ng, GROUP) of out_dtype."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, out_dtype)
    for t, name in ((a_g, "a_g"), (b_g, "b_g"), (c_g, "c_g")):
        if t is not None:
            _wrap.check_side(t, ng, name, packed.device)
    if packed.device.type == "cpu":
        return lanes.model_decode(packed, a_g, b_g, c_g, bits, out_dtype)
    out = _wrap.empty_out(ng, out_dtype, packed.device)
    _wrap.launch(
        "gt_model_decode", packed.device, packed.data_ptr(), a_g.data_ptr(), b_g.data_ptr(),
        None if c_g is None else c_g.data_ptr(), out.data_ptr(), ng, bits, _wrap.OUT_BYTES[out_dtype],
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`model_decode` that decode ``col`` (prepped
    streams; the coefficients as (ng,) views whatever form they came in)."""
    side = [streams[k].reshape(-1) if k in streams else None for k in ("a_g", "b_g", "c_g")]
    return (streams["packed"], *side, col.params["bits"], out_store)



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`model_decode` on ``args``, for
    roofline.ops_audit: ``model_decode_kernel<T, kPoly2>``, a block of 1024
    threads a group, no loop."""
    a = _wrap.bind(model_decode, args)
    kernel = f"gt::model_decode_kernel<{_wrap.T_NAME[a['out_dtype']]}, (bool){int(a['c_g'] is not None)}>"
    return [_wrap.Launch(kernel, a["packed"].shape[0] * LANES)]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: model_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("model", build, prep, narrow_store=True)
