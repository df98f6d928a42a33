"""Exception-patched decode: kernel K9 (csrc/patch_decode.cu ``patched_decode_kernel``).

Counterpart of giddy_tpu/kernels/patch.py: the base (nbit, or FOR with one
reference per group) unpacks, then the exceptions are written over it, in
one launch. The compressed kind's positions decode first through K3 on
the nested delta column (kernels/delta.py), cut to ``count`` as a view.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, LANES, num_groups
from . import _wrap, delta, lanes

LAUNCHES = 0


def prep(col: EncodedColumn) -> dict:
    """Host prep (giddy_tpu/kernels/patch.py:24-31): a FOR base's frame
    references become one per group (``base_refs_g``)."""
    streams = dict(col.streams)
    if col.params["base_scheme"] == "for":
        gpf = col.params["base_params"]["frame_len"] // GROUP
        ng = num_groups(col.n)
        streams["base_refs_g"] = np.repeat(streams.pop("base_refs"), gpf)[:ng]
    return streams


def patched_decode(packed: torch.Tensor, refs_g: torch.Tensor | None, pos: torch.Tensor, val: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(ng, bits*1024) base words (+ (ng,) refs_g for a FOR base, None for
    nbit) and the exceptions (pos strictly ascending, val) -> (ng, GROUP)
    of out_dtype with out[pos] = val."""
    global LAUNCHES
    ng = _wrap.check_packed(packed, bits, out_dtype)
    if refs_g is not None:
        _wrap.check_side(refs_g, ng, "refs_g", packed.device)
    count = _wrap.check_exceptions(pos, val, packed.device)
    if packed.device.type == "cpu":
        return lanes.patched_decode(packed, refs_g, pos, val, bits, out_dtype)
    out = _wrap.empty_out(ng, out_dtype, packed.device)
    _wrap.launch(
        "gt_patched_decode", packed.device, packed.data_ptr(),
        None if refs_g is None else refs_g.data_ptr(), pos.data_ptr(), val.data_ptr(), out.data_ptr(),
        ng, bits, count, _wrap.OUT_BYTES[out_dtype],
    )
    LAUNCHES += 1
    return out


def positions(col: EncodedColumn, streams: dict) -> torch.Tensor:
    """The exception positions on the streams' device: ``patch_pos``, or
    the nested delta column decoded by K3 and cut to ``count`` (a view)."""
    count = col.params["count"]
    if col.params["kind"] == "naive":
        return streams["patch_pos"]
    if count == 0:
        return streams["patch_val"]  # the empty int32 stream
    pos = delta.delta_decode(streams["ppos_packed"], streams["ppos_anchors"], col.params["ppos_bits"])
    return pos.reshape(-1)[:count]


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`patched_decode` that decode ``col`` (prepped streams)."""
    return (streams["base_packed"], streams.get("base_refs_g"), positions(col, streams), streams["patch_val"],
            col.params["base_params"]["bits"], out_store)



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`patched_decode` on ``args``, for
    roofline.ops_audit: ``patched_decode_kernel<T, kFor>`` (kFor: with the
    FOR references), a block of 1024 threads a group, whose loops are
    the exception phase's (_wrap.exception_trips)."""
    a = _wrap.bind(patched_decode, args)
    ng = a["packed"].shape[0]
    kernel = f"gt::patched_decode_kernel<{_wrap.T_NAME[a['out_dtype']]}, (bool){int(a['refs_g'] is not None)}>"
    return [_wrap.Launch(kernel, ng * LANES, _wrap.exception_trips(a["pos"].shape[0], ng))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: patched_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("patched", build, prep, narrow_store=True)
