"""Dense per-GROUP cumsum: kernel K6 (csrc/run_decode.cu ``cumsum_rows_kernel``).

Counterpart of giddy_tpu/kernels/rle.py ``_cumsum_rows_call``. It serves
rle/rpe's scatter form (kernels/rle.py) and ``scan.group_prefix_sum``.
"""

from __future__ import annotations

import torch

from ..util import GROUP, LANES
from . import _wrap, lanes

LAUNCHES = 0


def cumsum_rows(x: torch.Tensor, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    """(ng, GROUP) int32 -> inclusive cumsum along each row (mod 2^32), of
    out_dtype (each sum mapped through ``lut`` when given)."""
    global LAUNCHES
    _wrap.check_out_dtype(out_dtype)
    ng = _wrap.check_rows(x, "rows", GROUP)
    table = _wrap.lut_args(lut, x.device)
    if x.device.type == "cpu":
        return lanes.cumsum_rows(x, out_dtype, lut)
    out = _wrap.empty_out(ng, out_dtype, x.device)
    _wrap.launch("gt_cumsum_rows", x.device, x.data_ptr(), out.data_ptr(), ng, _wrap.OUT_BYTES[out_dtype], *table)
    LAUNCHES += 1
    return out


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`cumsum_rows` on ``args``, for roofline.ops_audit:
    ``cumsum_rows_kernel<T, LutMode>``, a block of 1024 threads a group;
    its only loop is the table's copy (kShared; the kernel's 64 words of
    warp totals beside it)."""
    a = _wrap.bind(cumsum_rows, args)
    mode = _wrap.lut_mode(a["lut"], static_words=64)
    return [_wrap.Launch(f"gt::cumsum_rows_kernel<{_wrap.T_NAME[a['out_dtype']]}, (gt::LutMode){mode}>",
                         a["x"].shape[0] * LANES, _wrap.lut_trips(a["lut"], mode))]
