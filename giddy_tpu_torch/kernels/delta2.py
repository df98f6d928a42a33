"""Delta-of-delta decode: kernel K7 (csrc/run_decode.cu ``delta2_decode_kernel``).

Counterpart of giddy_tpu/kernels/delta2.py: unpack, unzigzag, two
inclusive per-GROUP cumsums, then anchor[g] + slope[g]·(j+1), mod 2^32.
The kernel holds half a group's values at a time in 66 KB of shared
memory, so a cascade table beside them stays in shared memory only up to
``shared_lut_limit()`` entries (36,864 on an H100); above it the kernel
reads the table from global memory.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..util import LANES
from . import _build, _wrap, lanes

LAUNCHES = 0


def lut_in_shared(d: int) -> bool:
    """Whether K7 keeps a d-entry cascade table in shared memory on the
    current CUDA device (else it reads it from global memory)."""
    return bool(_build.lib().gt_delta2_shared(d))


def shared_lut_limit() -> int:
    """The largest d for which :func:`lut_in_shared` holds on the current
    CUDA device (a bisection over d in [1, 65536])."""
    lo, hi = 1, 65536
    if not lut_in_shared(lo) or lut_in_shared(hi):
        raise RuntimeError("K7's shared table holds no entry, or 65536")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if lut_in_shared(mid) else (lo, mid)
    return lo


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



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`delta2_decode` on ``args``, for
    roofline.ops_audit: ``delta2_decode_kernel<T, LutMode>``, a block of
    1024 threads a group: the table's copy (kShared, where
    :func:`lut_in_shared` says), then the two passes, kept rolled
    (``#pragma unroll 1``)."""
    a = _wrap.bind(delta2_decode, args)
    lut = a["lut"]
    mode = 0 if lut is None else 1 if lut_in_shared(lut.shape[0]) else 2
    return [_wrap.Launch(f"gt::delta2_decode_kernel<{_wrap.T_NAME[a['out_dtype']]}, (gt::LutMode){mode}>",
                         a["packed"].shape[0] * LANES, (*_wrap.lut_trips(lut, mode), 2))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: delta2_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("delta2", build, narrow_store=True)
