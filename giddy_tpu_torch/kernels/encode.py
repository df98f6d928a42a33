"""Device encode: kernel K18 (csrc/encode.cu ``lmp_pack_kernel``) and the
encoders around it.

Counterpart of giddy_tpu/kernels/encode.py, function for function and
under the same names. K18 packs LMP(B) words, with the FOR subtract or the
delta difference and zigzag fused in front of the pack; every other step
is a torch op, as it is a ``jnp`` op in the reference: the per-frame min of
FOR, the delta anchors, the RLE run tables, the dictionary code search. The
dictionary itself and the run-table stride ``r_pad`` are chosen on the
host, as there.

The tensor-level functions run on the device of the tensor they are
given; the ``encode_*_device`` entry points take ``device="cuda"`` unless
the caller asks for the CPU. Payloads ride as int32 tensors carrying the
uint32 bits (a uint32 tensor is viewed so). Every result is bit-identical
to the reference's, and every ``EncodedColumn`` byte-identical to the
port's host encoder (ref/), except dict at n = 0, where the reference
raises and the port returns the host encoder's column (ROADMAP.md §3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..format import EncodedColumn
from ..ref import dict_ as ref_dict
from ..util import (
    GROUP, LANES, bits_needed, check_device_addressable, dtype_to_u32, next_power_of_2, pad_to_groups,
)
from . import _wrap, lanes

LAUNCHES = 0
INT_MIN = -(2**31)  # x ^ INT_MIN: unsigned order as signed int32 order


def lmp_pack(values: torch.Tensor, bits: int, prologue: str = "none", refs: torch.Tensor | None = None, n: int | None = None, frame_len: int = GROUP) -> torch.Tensor:
    """(ng, GROUP) int32 values -> (ng, bits*1024) int32 LMP(bits) words of
    the values after ``prologue`` (lanes.lmp_pack): ``none``, ``for_sub``
    (refs: one int32 per frame of ``frame_len`` values) or
    ``delta_zigzag`` (n: the logical length, default all)."""
    global LAUNCHES
    ng = _wrap.check_pack(values, bits, prologue, refs, frame_len)
    n = ng * GROUP if n is None else n
    if values.device.type == "cpu":
        return lanes.lmp_pack(values, bits, prologue, refs, n, frame_len)
    out = torch.empty((ng, bits * LANES), dtype=torch.int32, device=values.device)
    _wrap.launch(
        "gt_lmp_pack", values.device, values.data_ptr(), _wrap.ptr(refs) if prologue == "for_sub" else None,
        out.data_ptr(), ng, bits, _wrap.PROLOGUES.index(prologue), n, frame_len // GROUP,
    )
    LAUNCHES += 1
    return out



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`lmp_pack` on ``args``, for roofline.ops_audit:
    ``lmp_pack_kernel<B, Prologue>``, a block of 1024 threads a group, no
    loop (the FOR prologue's frame index may call the compiler's 64-bit
    division, a subroutine the census counts at its call)."""
    a = _wrap.bind(lmp_pack, args)
    kernel = f"gt::lmp_pack_kernel<(int){a['bits']}, (gt::Prologue){_wrap.PROLOGUES.index(a['prologue'])}>"
    return [_wrap.Launch(kernel, a["values"].shape[0] * LANES)]

def _rows(values: torch.Tensor) -> torch.Tensor:
    """Flat payloads padded to whole GROUPs -> (ng, GROUP) int32."""
    if values.dtype == torch.uint32:
        values = values.view(torch.int32)
    if values.dim() != 1 or values.shape[0] == 0 or values.shape[0] % GROUP:
        raise ValueError(f"values must be 1-D and padded to whole GROUPs of {GROUP}, got {tuple(values.shape)}")
    check_device_addressable(values.shape[0], "device encode")
    return values.reshape(-1, GROUP)


def _device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("encode on a CUDA device, but torch sees no CUDA device")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no device encoder for device {device}")
    return device


def _host(values) -> np.ndarray:
    return values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A 1-D array of 4-byte payloads as an int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _words(t: torch.Tensor) -> np.ndarray:
    """Packed int32 words back on the host as the host encoder's uint32."""
    return t.cpu().numpy().view(np.uint32)


def nbit_pack_device(values: torch.Tensor, bits: int) -> torch.Tensor:
    """values: flat payloads padded to a GROUP multiple -> (ng, bits*LANES)
    packed words, computed on the values' device."""
    return lmp_pack(_rows(values), bits)


def delta_streams_device(values: torch.Tensor, bits: int, n: int | None = None) -> tuple:
    """The delta scheme's streams (FORMAT.md §1.3): zigzag deltas packed
    LMP(bits) and per-group anchors, v[0] for group 0 and v[g*GROUP - 1]
    for the others. ``n`` is the logical length: tail-pad deltas are 0
    like the host encoder's."""
    v = _rows(values)
    anchors = torch.roll(v[:, -1], 1)
    anchors[0] = v[0, 0]
    return lmp_pack(v, bits, "delta_zigzag", n=v.numel() if n is None else n), anchors


def for_streams_device(values: torch.Tensor, bits: int, frame_len: int) -> tuple:
    """The FOR scheme's streams (FORMAT.md §1.2): packed offsets from the
    per-frame (unsigned) min references, and the references. ``values``
    must be padded to whole frames (last-value fill, as the host encoder
    pads)."""
    v = _rows(values)
    if frame_len < GROUP or frame_len % GROUP or v.numel() % frame_len:
        raise ValueError(f"values ({v.numel()}) must be padded to whole frames of frame_len={frame_len}, "
                         f"a multiple of GROUP={GROUP}")
    refs = (v.reshape(-1, frame_len) ^ INT_MIN).amin(1) ^ INT_MIN
    return lmp_pack(v, bits, "for_sub", refs=refs, frame_len=frame_len), refs


def encode_nbit_device(values, *, bits: int, name: str = "col", device: torch.device | str = "cuda") -> EncodedColumn:
    """End-to-end device nbit encode: the same EncodedColumn as the host
    encoder (ref/nbit.py)."""
    device = _device(device)
    v = _host(values)
    u = pad_to_groups(dtype_to_u32(v))
    packed = nbit_pack_device(_upload(u, device), bits)
    return EncodedColumn(
        name=name, scheme="nbit", dtype=str(v.dtype), n=v.shape[0],
        params={"bits": int(bits)}, streams={"packed": _words(packed)},
    )


def _run_starts(v: torch.Tensor) -> torch.Tensor:
    """(ng, GROUP) -> True where a run starts (each group's first value,
    and every value unlike the one before it)."""
    start = torch.ones_like(v, dtype=torch.bool)
    start[:, 1:] = v[:, 1:] != v[:, :-1]
    return start


def rle_run_counts_device(values: torch.Tensor) -> torch.Tensor:
    """Per-group run counts (int32) of padded payloads: the sizing pass of
    the device RLE encode (r_pad is picked from their max on the host)."""
    return _run_starts(_rows(values)).sum(1, dtype=torch.int32)


def rle_streams_device(values: torch.Tensor, r_pad: int) -> tuple:
    """The RLE run tables (FORMAT.md §1.5) of payloads padded to whole
    GROUPs with last-value fill: (run_values, run_ends) as (ng, r_pad)
    int32 and the (ng,) run counts. Run ranks come from a per-group cumsum
    of the run starts; run values and ends from two scatters into buffers
    one longer than ng*r_pad, where every non-start lands on the extra
    slot, which is cut off. r_pad must cover every group
    (rle_run_counts_device)."""
    v = _rows(values)
    ng = v.shape[0]
    start = _run_starts(v)
    rank = torch.cumsum(start, 1, dtype=torch.int32) - 1
    counts = rank[:, -1] + 1
    g = torch.arange(ng, device=v.device)[:, None] * r_pad
    j = torch.arange(GROUP, dtype=torch.int32, device=v.device).expand(ng, GROUP)
    sentinel = ng * r_pad
    rv = torch.zeros(sentinel + 1, dtype=torch.int32, device=v.device)
    rv.index_put_((torch.where(start, g + rank, sentinel).reshape(-1),), v.reshape(-1))
    # run r ends where run r + 1 starts; the group's last real run (and
    # every pad run) ends at GROUP, the fill
    re_ = torch.full((sentinel + 1,), GROUP, dtype=torch.int32, device=v.device)
    re_.index_put_((torch.where(start & (j > 0), g + rank - 1, sentinel).reshape(-1),), j.reshape(-1))
    rv = rv[:sentinel].view(ng, r_pad)
    # pad runs repeat the group's last real value (FORMAT.md §1.5)
    last = rv.gather(1, (counts - 1).to(torch.int64)[:, None])
    r_idx = torch.arange(r_pad, device=v.device)
    rv = torch.where(r_idx >= counts[:, None], last, rv)
    return rv, re_[:sentinel].view(ng, r_pad), counts


def encode_rle_device(values, *, name: str = "col", device: torch.device | str = "cuda") -> EncodedColumn:
    """End-to-end device RLE encode: the same EncodedColumn as the host
    encoder (ref/rle.py). Only r_pad (one read of the largest run count)
    is chosen on the host."""
    device = _device(device)
    v = _host(values)
    n = v.shape[0]
    u = dtype_to_u32(v)
    u = pad_to_groups(u, fill=int(u[-1])) if n else np.zeros(GROUP, dtype=np.uint32)
    dev = _upload(u, device)
    r_pad = max(8, next_power_of_2(int(rle_run_counts_device(dev).max())))
    rv, re_, counts = rle_streams_device(dev, r_pad)
    return EncodedColumn(
        name=name, scheme="rle", dtype=str(v.dtype), n=n,
        params={"r_pad": int(r_pad)},
        streams={
            "run_values": rv.cpu().numpy().reshape(-1),
            "run_ends": re_.cpu().numpy().reshape(-1),
            "run_counts": counts.cpu().numpy(),
        },
    )


def dict_codes_device(values: torch.Tensor, staged: torch.Tensor, code_of_rank: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Code of each payload: its rank in the payload-sorted ``staged``
    dictionary (an unsigned binary search, clamped to the dictionary),
    mapped through ``code_of_rank`` to the dictionary's logical order
    (identity for floats, the signed order's permutation for ints: FORMAT
    §1.4 stores the dictionary in logical order). Codes at positions >= n
    are 0, like the host packer's zero fill. int32 codes."""
    d = staged.shape[0]
    if d == 0:
        raise ValueError("an empty dictionary assigns no codes")
    v = values.view(torch.int32) if values.dtype == torch.uint32 else values
    pos = torch.searchsorted(staged.view(torch.int32) ^ INT_MIN, v ^ INT_MIN).clamp_(0, d - 1)
    codes = code_of_rank.view(torch.int32)[pos]
    i = torch.arange(v.shape[0], device=v.device)
    return torch.where(i < (v.shape[0] if n is None else n), codes, 0)


def encode_dict_device(values, *, bits: int | None = None, name: str = "col", device: torch.device | str = "cuda") -> EncodedColumn:
    """Device dict encode: the dictionary is built on the host (np.unique);
    the O(n) work, the code search and the LMP pack, runs on the device.
    The same EncodedColumn as the host encoder's dense path (ref/dict_.py);
    at n = 0 it is the host encoder's column, and nothing is launched."""
    device = _device(device)
    v = _host(values)
    n = v.shape[0]
    if n == 0:
        return ref_dict.encode(v, bits=bits, name=name)
    work = dtype_to_u32(v)
    if v.dtype.kind == "f":
        dic_payload = np.unique(work)
        store = dic_payload.view(np.int32)
        order = np.arange(dic_payload.shape[0], dtype=np.uint32)
    else:
        dic_payload = dtype_to_u32(np.unique(v))
        store = dic_payload.astype(np.int32)
        order = np.argsort(dic_payload, kind="stable").astype(np.uint32)
    d = int(dic_payload.shape[0])
    if bits is None:
        bits = bits_needed(max(d - 1, 0))
    codes = dict_codes_device(
        _upload(pad_to_groups(work), device), _upload(dic_payload[order], device), _upload(order, device), n=n,
    )
    return EncodedColumn(
        name=name, scheme="dict", dtype=str(v.dtype), n=n,
        params={"bits": int(bits), "dict_size": d, "dense": True},
        streams={"codes": _words(nbit_pack_device(codes, bits)), "values": store},
    )
