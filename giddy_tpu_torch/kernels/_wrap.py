"""Argument checks and launch plumbing shared by the kernel wrappers.

A wrapper takes its plain PyTorch version only when its tensors lie on the
CPU; on a CUDA tensor it launches its kernel or raises. Any other device,
dtype, shape or layout that the kernel does not take raises here. The
wrappers of K1-K3 and K5-K7 take an optional ``lut``: the (d,) int32
dictionary of cascade's fused stage (kernels/cascade.py).
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import NamedTuple

import torch

from .. import trace
from ..util import GROUP, LANES
from . import _build

# Output element types the kernels store, by their width in bytes: the
# uint32 payload as int32, and the narrow int16 / uint8 stores.
OUT_BYTES = {torch.int32: 4, torch.int16: 2, torch.uint8: 1}
# Logical dtype kinds of the scan epilogue, in the kernels' numbering.
SCAN_KINDS = ("u", "i", "f")


def check_out_dtype(out_dtype: torch.dtype) -> None:
    if out_dtype not in OUT_BYTES:
        raise TypeError(f"out_dtype must be one of {list(OUT_BYTES)}, got {out_dtype}")


def check_rows(t: torch.Tensor, name: str, width: int | None = None) -> int:
    """Validate a contiguous 2-D int32 tensor of rows (``width`` wide when
    given) on the CPU or a CUDA device; returns its row count."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bits), got {t.dtype}")
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1 or t.shape[1] != (width or t.shape[1]):
        want = f"(rows >= 1, {width})" if width else "(rows >= 1, >= 1)"
        raise ValueError(f"{name} must have shape {want}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode kernel for device {t.device}")
    return t.shape[0]


def check_packed(packed: torch.Tensor, bits: int, out_dtype: torch.dtype) -> int:
    """Validate an LMP(bits) word stream and the output type; returns ng."""
    if not isinstance(bits, int) or not 1 <= bits <= 32:
        raise ValueError(f"bits must be an int in [1, 32], got {bits!r}")
    check_out_dtype(out_dtype)
    return check_rows(packed, "packed words", bits * LANES)


# The value transforms K18 can fuse in front of the pack, in the kernel's
# numbering (csrc/encode.cu Prologue).
PROLOGUES = ("none", "for_sub", "delta_zigzag")


def check_pack(values: torch.Tensor, bits: int, prologue: str, refs: torch.Tensor | None, frame_len: int) -> int:
    """Validate K18's (ng, GROUP) int32 values, width, prologue and, for
    ``for_sub``, the (frames,) int32 references of frame_len-value frames;
    returns ng."""
    if not isinstance(bits, int) or not 1 <= bits <= 32:
        raise ValueError(f"bits must be an int in [1, 32], got {bits!r}")
    if prologue not in PROLOGUES:
        raise ValueError(f"prologue must be one of {PROLOGUES}, got {prologue!r}")
    if not isinstance(frame_len, int) or frame_len < GROUP or frame_len % GROUP or frame_len // GROUP > 2**31 - 1:
        raise ValueError(f"frame_len must be a positive multiple of GROUP={GROUP}, got {frame_len!r}")
    ng = check_rows(values, "values", GROUP)
    if prologue == "for_sub":
        if refs is None:
            raise ValueError("the for_sub prologue needs refs")
        gpf = frame_len // GROUP
        check_side(refs, -(-ng // gpf), "refs", values.device)
    return ng


def check_side(t: torch.Tensor, length: int | None, name: str, device: torch.device) -> None:
    """Validate a 1-D int32 side stream (refs, anchors, dictionary) of
    ``length`` values, or of at least one when ``length`` is None."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] < 1 or t.shape[0] != (length or t.shape[0]):
        want = f"({length},)" if length else "(d >= 1,)"
        raise ValueError(f"{name} must have shape {want}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the packed words on {device}")


def check_scan(kind: str, itemsize: int, refs_g: torch.Tensor | None, valid: torch.Tensor | None, ng: int, device: torch.device) -> None:
    """Validate the scan epilogue's (K16, K17) logical dtype and its
    optional per-group refs and (ng, LANES) validity words."""
    if kind not in SCAN_KINDS or itemsize not in (1, 2, 4):
        raise ValueError(f"kind must be one of {SCAN_KINDS} and itemsize 1, 2 or 4, got {kind!r}, {itemsize!r}")
    if refs_g is not None:
        check_side(refs_g, ng, "refs_g", device)
    if valid is not None:
        if check_rows(valid, "valid words", LANES) != ng:
            raise ValueError(f"valid words hold {valid.shape[0]} groups, the packed words {ng}")
        if valid.device != device:
            raise ValueError(f"valid words are on {valid.device}, the packed words on {device}")


# The staged walk of K16 and K17 (csrc/scan_epilogue.cu walk_tiles): a
# tile is B KB of packed words (+ 1 KB of validity words) for 256 lanes.
TILES_PER_GROUP = LANES // 256
MAX_STAGES = 8
RING_HEADER = 128  # the stages' mbarriers
BLOCK_RESERVED = 1024  # shared memory the runtime keeps for each block (sm_80 on)
IN_FLIGHT = 16 * 1024  # bytes an SM should keep in flight to stream HBM (Little's law)
H100_SHARED_PER_SM = 233_472  # 228 KB; a block may opt in to 227 KB of it


def scan_plan(bits: int, nullable: bool, shared_per_sm: int = H100_SHARED_PER_SM) -> tuple[int, int]:
    """(stages, blocks an SM) of K16/K17's tile ring at B = ``bits``: the
    most blocks an SM (4 down to 1) at which at least two stages fit, and
    with them up to MAX_STAGES stages, such that the SM keeps >= IN_FLIGHT
    bytes of packed words in flight (stages - 1 tiles a block)."""
    tile = (bits + nullable) * 1024
    for blocks in (4, 3, 2, 1):
        per_block = shared_per_sm // blocks - BLOCK_RESERVED
        stages = min(MAX_STAGES, (per_block - RING_HEADER) // tile)
        if stages >= 2 and blocks * (stages - 1) * bits * 1024 >= IN_FLIGHT:
            return stages, blocks
    raise ValueError(f"no tile ring fits {shared_per_sm} B of shared memory at bits={bits}")


def check_aligned(streams: dict) -> None:
    """Raise unless every stream ({name: tensor or None}) that a kernel
    stages with bulk async copies starts 16-byte aligned: a misaligned
    copy faults."""
    for name, t in streams.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the bulk copies, got address {t.data_ptr():#x}")


def walk_args(packed: torch.Tensor, valid: torch.Tensor | None, bits: int) -> tuple[int, int]:
    """(stages, grid) of a K16/K17 launch on ``packed``'s card, after the
    bulk copies' check that ``packed`` and ``valid`` are 16-byte aligned."""
    check_aligned({"packed words": packed, "valid words": valid})
    shared_per_sm, sms = _card(packed.device)
    stages, blocks = scan_plan(bits, valid is not None, shared_per_sm)
    return stages, min(blocks * sms, packed.shape[0] * TILES_PER_GROUP)


# The staged dzbv kernels K13, K14 and K15 (csrc/dzbv_decode.cu
# dzbv_staged_kernel): a block of 1024 threads decodes one group from its
# plane bytes, staged back to back in dynamic shared memory beside its
# static rank table. Two blocks fill an SM's 2048 threads: they fit at
# every K13 stride and K14 row width, and for K15 at one or two planes.
DZBV_ROW_UNIT = {"tile": 256, "group": 4096}  # a row's bytes per unit of s_k (K13) or w4_k (K14)
# K15 sizes every block for the most rows of 4 KB that a group's ranks in
# one plane can touch: up to 32768 ranks from any byte of a row, 9 rows.
DZBV_PLANE_WINDOW = 9 * 4096
# Static shared memory a block: the (slot, warp) table, K14's warp sums and
# the mbarrier, rounded up to the rows' 128-byte alignment (ptxas: 8576 B
# for K14, 8320 for K13).
DZBV_STATIC = 8576


def dzbv_plan(form: str, shapes) -> int:
    """Bytes of dynamic shared memory of a K13 (``form`` "tile", ``shapes``
    the planes' strides s_k), K14 ("group", row widths w4_k) or K15
    ("plane", the streams' row counts) block: the present planes' group
    rows, or K15's windows (a shape of None or 0: the plane is absent), as
    the kernel's launch computes them (stage_rows)."""
    if form == "plane":
        return DZBV_PLANE_WINDOW * sum(bool(a) for a in shapes)
    return sum(DZBV_ROW_UNIT[form] * a for a in shapes if a)


@functools.cache
def _card(device: torch.device) -> tuple[int, int]:
    """(shared memory an SM, SMs) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_multiprocessor, props.multi_processor_count


def ptr(t: torch.Tensor | None) -> int | None:
    """The device pointer of an optional tensor (None passes NULL)."""
    return None if t is None else t.data_ptr()


def check_exceptions(pos: torch.Tensor, val: torch.Tensor, device: torch.device) -> int:
    """Validate the exceptions of K9 and K12 (positions and values, 1-D
    int32 of one length on ``device``); returns their count."""
    for t, name in ((pos, "pos"), (val, "val")):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the packed words on {device}")
    if pos.shape != val.shape:
        raise ValueError(f"pos {tuple(pos.shape)} and val {tuple(val.shape)} differ in length")
    return pos.shape[0]


def lut_args(lut: torch.Tensor | None, device: torch.device) -> tuple:
    """(pointer, d) of the optional dictionary of a kernel's LUT stage:
    (None, 0) launches the plain kernel."""
    if lut is None:
        return None, 0
    check_side(lut, None, "lut", device)
    return lut.data_ptr(), lut.shape[0]


def empty_out(ng: int, out_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.empty((ng, GROUP), dtype=out_dtype, device=device)


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point of the kernel library on ``device`` and its
    current PyTorch stream (passed last); raise on a CUDA error."""
    with trace.span("launch", fn_name), torch.cuda.device(device):
        rc = getattr(_build.lib(), fn_name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")


# -- what roofline.ops_audit needs of a launch ---------------------------------


class Launch(NamedTuple):
    """One kernel launch of a wrapper call, for the SASS census
    (roofline.sass_census): the instance's name as roofline.kernel_key
    gives it (a template instance is a SASS function of its own), the
    threads launched, and its loops' trips in SASS order: the times a warp
    runs the body, averaged over the warps launched, per run of the
    enclosing loop's body; None where the trips are data."""

    kernel: str
    threads: int
    trips: tuple = ()


def bind(fn, args: tuple) -> dict:
    """The arguments ``args`` of wrapper ``fn`` by name, defaults filled in."""
    bound = inspect.signature(fn).bind(*args)
    bound.apply_defaults()
    return bound.arguments


# The output type T of a kernel instance, as the demangled name spells it.
T_NAME = {torch.int32: "unsigned int", torch.int16: "unsigned short", torch.uint8: "unsigned char"}


def lut_mode(lut: torch.Tensor | None, static_words: int = 0) -> int:
    """The gt::LutMode a launch with ``lut`` takes (choose_lut in
    csrc/lmp.cuh): 0 without a table, 1 when it fits a block's shared
    memory beside the kernel's ``static_words`` of its own, else 2."""
    if lut is None:
        return 0
    return 1 if _build.lib().gt_dict_shared(lut.shape[0] + static_words) else 2


def strided_trips(n: int, block: int = LANES) -> float:
    """Trips of ``for (j = threadIdx.x; j < n; j += block)`` (a block
    copying a table), averaged over the block's warps: warp w runs it
    while one of its lanes has j < n."""
    warps = block // 32
    return sum(max(0, math.ceil((n - 32 * w) / block)) for w in range(warps)) / warps


def lut_trips(lut: torch.Tensor | None, mode: int) -> tuple:
    """The table copy's loop, which only the shared-memory instance has."""
    return (strided_trips(lut.shape[0]),) if mode == 1 else ()


def exception_trips(count: int, ng: int) -> tuple:
    """gt::patch_group's two loops (csrc/lmp.cuh), or none of their runs
    when there is no exception (it returns first): the binary search, run
    by warp 0 (two lanes) at most bit_length(count) times, and the write
    of a group's exceptions, a lane each, which takes at least count / 32
    warp runs over the column (exact when each group's exceptions fill
    whole warps). Averaged over the ng * 32 warps."""
    if count == 0:
        return (0, 0)
    return (count.bit_length() / 32, count / 32 / (ng * 32))


def init_trips(stages: int) -> tuple[int, int, int]:
    """How the compiler runs walk_tiles' loop over the stages' barriers,
    ``for (s = 0; s < stages; ++s)``, in its SASS: a body of 16 a turn
    while more than 12 of the multiple of 4 remain (then 8 inline when more
    than 4 do), a body of 4 a turn for the rest of that multiple, and a
    body of 1 for stages % 4."""
    rest = stages & 3
    whole = stages - rest if stages >= 4 else 0
    t16 = max(0, math.ceil((whole - 12) / 16))
    whole -= 16 * t16
    if whole > 4:
        whole -= 8
    return t16, whole // 4, rest


def walk_trips(ng: int, bits: int, nullable: bool, stages: int, grid: int, inline_wait: bool = False) -> tuple:
    """The 21 loops of one copy of walk_tiles (csrc/scan_epilogue.cu) in
    K16's and K17's SASS: the barrier loop (init_trips; thread 0), the
    prefill loop over stages - 1 tiles and the tile loop, each holding
    warp 0's issue: the compiler peels the first three turns of ``for (w =
    lane; w < pieces; w += 32)`` and unrolls the rest by 4, and each bulk
    copy is a loop over the lanes that start one (the copy's operands must
    be warp-uniform): min(32, pieces) lanes in the first turn, pieces - 32
    in the second; pieces <= 33 never reaches the third or the unrolled
    rest. A block of 8 warps takes tiles b, b + grid, ...; it issues in
    each prefill turn whose tile exists and in every tile turn but the last
    stages - 1. Where the compiler keeps the mbarrier wait's retry loop
    (barrier_wait's ``while (!done)``) inside the tile loop and not out of
    line (``inline_wait``), it is one loop more, whose trips are the copy's
    timing: charged once a tile."""
    warps = 8
    tiles = ng * TILES_PER_GROUP
    pieces = bits + nullable
    per_block = [math.ceil((tiles - b) / grid) for b in range(grid)]
    prefill = sum(min(k, stages - 1) for k in per_block) / (grid * max(stages - 1, 1))
    issuing = sum(max(0, k - stages + 1) for k in per_block) / max(sum(per_block), 1)
    lanes = (min(32, pieces), max(0, min(32, pieces - 32)), 0)

    def copies(share: float) -> tuple:
        return (*(n * share / warps for n in lanes), 0, 0, 0, 0, 0)

    init = tuple(t / warps for t in init_trips(stages))
    wait = (None,) if inline_wait else ()
    return (*init, stages - 1, *copies(prefill), tiles / grid, *copies(issuing), *wait)


def scan_launch(kernel: str, packed: torch.Tensor, valid: torch.Tensor | None, bits: int, kind: str,
                itemsize: int, inline_wait: bool = False) -> Launch:
    """K16's or K17's launch on ``packed`` (``kernel`` its instance): the
    grid of walk_args, and walk_trips for each copy of walk_tiles; a signed
    kind's SASS holds the 32-bit copy first, then the narrow one."""
    stages, grid = walk_args(packed, valid, bits)
    trips = walk_trips(packed.shape[0], bits, valid is not None, stages, grid, inline_wait)
    if kind == "i":
        none = (0,) * len(trips)
        trips = trips + none if itemsize == 4 else none + trips
    return Launch(kernel, grid * 256, trips)
