"""Dictionary decode: kernel K4 (csrc/lmp_decode.cu ``dict_decode_kernel``).

Counterpart of giddy_tpu/kernels/dict_.py. One kernel for every
dictionary size: it stages the dictionary in shared memory when it fits
and reads it from global memory above that (``dict_in_shared``). The
reference's 2048-entry switch between a fused gather and an XLA take is a
TPU cost threshold and has no counterpart here.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, LANES
from . import _build, _wrap, lanes

LAUNCHES = 0


def dict_in_shared(d: int) -> bool:
    """Whether the kernel stages a d-entry dictionary in shared memory on
    the current CUDA device (else it reads it from global memory)."""
    return bool(_build.lib().gt_dict_shared(d))


def dict_decode(codes: torch.Tensor, values: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(ng, bits*1024) LMP codes + (d,) dictionary -> (ng, GROUP) values[code]."""
    global LAUNCHES
    ng = _wrap.check_packed(codes, bits, out_dtype)
    _wrap.check_side(values, None, "values", codes.device)
    d = values.shape[0]
    if codes.device.type == "cpu":
        return lanes.dict_decode(codes, values, bits, out_dtype)
    out = _wrap.empty_out(ng, out_dtype, codes.device)
    _wrap.launch(
        "gt_dict_decode", codes.device, codes.data_ptr(), values.data_ptr(), out.data_ptr(),
        ng, bits, d, _wrap.OUT_BYTES[out_dtype],
    )
    LAUNCHES += 1
    return out


def args(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple:
    """The arguments of :func:`dict_decode` that decode ``col`` (d >= 1)."""
    return streams["codes"], streams["values"], col.params["bits"], out_store


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`dict_decode` on ``args``, for roofline.ops_audit:
    K1's ``lmp_unpack_kernel<T, LutMode>`` with the
    dictionary as its table, in shared memory (and the table's copy its
    loop) or read from global memory."""
    a = _wrap.bind(dict_decode, args)
    mode = _wrap.lut_mode(a["values"])
    return [_wrap.Launch(f"gt::lmp_unpack_kernel<{_wrap.T_NAME[a['out_dtype']]}, (gt::LutMode){mode}>",
                         a["codes"].shape[0] * LANES, _wrap.lut_trips(a["values"], mode))]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    if col.params["dict_size"] == 0:
        # empty column: no dictionary; the padded output is all-zero codes,
        # as in the reference, and no kernel runs
        def empty(streams):
            codes = streams["codes"]
            return torch.zeros(codes.shape[0] * GROUP, dtype=out_store, device=codes.device)

        return empty

    return lambda streams: dict_decode(*args(col, streams, out_store)).reshape(-1)


registry.register_device("dict", build, narrow_store=True)
