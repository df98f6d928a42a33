"""Dense per-GROUP cumsum: kernel K6 (csrc/run_decode.cu ``cumsum_rows_kernel``).

Counterpart of giddy_tpu/kernels/rle.py ``_cumsum_rows_call``. It serves
rle/rpe's scatter form (kernels/rle.py) and ``scan.group_prefix_sum``.
"""

from __future__ import annotations

import torch

from ..util import GROUP
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
