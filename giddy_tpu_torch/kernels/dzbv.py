"""dzbv decode: kernels K13, K14 and K15 (csrc/dzbv_decode.cu), one per
stream form of the byte planes.

Counterpart of giddy_tpu/kernels/dzbv.py. On disk, plane k (1..3) holds
byte k of every value wider than k bytes, compacted over the whole column.
The host prep re-anchors the planes, byte for byte as the reference does at
its constants, into the first form whose padding stays under ``PAD_CAP``:

1. the tile form, ``trow{k}``: each 128-value tile's bytes at ``t*s_k`` of
   its group's row, ``s_k`` a multiple of 8 for the whole column — K13
   ranks within the tile;
2. the group-row form, ``prow{k}``: each group's bytes front-compacted in
   a row of ``w4_k * 1024`` words — K14 ranks within the group;
3. the on-disk planes themselves — K15 ranks over the column, from
   per-group offsets (a count kernel, then a torch cumsum over the groups,
   where the reference takes an XLA cumsum).

The constants of the choice (``_OPS_*``, ``_KAPPA``) are the reference's
TPU costs: kept as they are, the port picks the reference's form.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .. import registry
from ..format import EncodedColumn
from ..ref.lmp import lmp_pack, lmp_unpack
from ..util import GROUP, LANES, cdiv, num_groups
from . import _wrap, lanes

# The reference's constants (giddy_tpu/kernels/dzbv.py:57-79).
PAD_CAP = 0.15
TILE = 128
TPG = GROUP // TILE  # tiles per group row
STRIDE_Q = 8
_DIVISORS = (8, 16, 32, 64, 128)
_OPS_BASE = 14.0
_OPS_PLANE = 13.0
_OPS_STRADDLE = 4.0
_KAPPA = 4.6

LAUNCHES = dict.fromkeys(("dzbv_tile_decode", "dzbv_group_decode", "dzbv_plane_decode"), 0)


def _stride_for(max_cnt: int) -> int:
    # per-tile count is <= 128 by definition
    return min(cdiv(max(max_cnt, 1), STRIDE_Q) * STRIDE_Q, TILE)


def _row_width(max_cnt: int) -> int:
    """w4: the group row's width in units of 1024 words (4096 bytes)."""
    return max(1, cdiv(cdiv(max_cnt, LANES), 4))


def _straddle_frac(s: int) -> float:
    """Fraction of tiles whose 128-lane source window straddles a lane
    boundary at stride ``s`` (0 for divisors of 128): a TPU cost."""
    mP = TILE // math.gcd(TILE, s)
    nP = mP * s // TILE
    return (nP - 1) / mP


def choose_strides(max_cnts: dict[int, int], means: dict[int, float] | None = None) -> dict[int, int]:
    """Per-plane stride: of the tight stride and the next divisor of 128,
    the combination of least modelled ``max(ops, bytes * KAPPA)`` a value,
    among those whose stored bytes stay within 1.12x of the ideal when
    ``means`` (mean plane bytes a value) are given."""
    planes = sorted(max_cnts)
    cands = []
    for k in planes:
        mx = max(int(max_cnts[k]), 1)
        tight = _stride_for(mx)
        div = next(s for s in _DIVISORS if s >= mx)
        cands.append(sorted({tight, div}))
    ideal = None
    if means is not None:
        ideal = 0.25 + 1.0 + 4.0 + sum(means.get(k, 0.0) for k in planes)
    best = best_any = None
    for combo in itertools.product(*cands):
        ops = _OPS_BASE
        bytes_pe = 0.25 + 1.0 + 4.0  # widths + plane0 + the decoded write
        for s in combo:
            ops += _OPS_PLANE + _OPS_STRADDLE * _straddle_frac(s)
            bytes_pe += s / TILE
        score = max(ops, _KAPPA * bytes_pe)
        if best_any is None or (bytes_pe, score) < best_any[:2]:
            best_any = (bytes_pe, score, combo)
        if ideal is not None and bytes_pe > 1.12 * ideal:
            continue
        if best is None or score < best[0]:
            best = (score, combo)
    combo = best[1] if best is not None else best_any[2]
    return dict(zip(planes, combo))


def _width_codes(col: EncodedColumn) -> np.ndarray:
    """w - 1 of every value, padded to whole groups (the pad reads 0)."""
    return lmp_unpack(col.streams["widths"], 2, num_groups(col.n) * GROUP).astype(np.int32)


def _plane_bytes(col: EncodedColumn, k: int, total: int) -> np.ndarray:
    """The first ``total`` bytes of plane k (a sliced column's plane may
    hold zero padding past them)."""
    return lmp_unpack(col.streams[f"plane{k}"][: num_groups(total)], 8, total)


def _tile_counts(w: np.ndarray, present) -> dict[int, np.ndarray]:
    """{plane k: counts of the values with w > k in each 128-value tile}."""
    return {k: (w >= k).reshape(-1, TILE).sum(axis=1) for k in present}


def form_streams(col: EncodedColumn, form: str) -> dict:
    """The column's streams in one form, "tile", "group" or "plane", whatever
    PAD_CAP says (the prep takes the first form under it): the tile form at
    the strides tile_prep would choose, the group-row form at the least
    row widths, or the on-disk planes."""
    if form == "plane":
        return col.streams
    present = [k for k in (1, 2, 3) if col.params["plane_lens"][k] > 0]
    w = _width_codes(col)
    if form == "tile":
        cnts = _tile_counts(w, present)
        return tile_prep(col, force_s=choose_strides({k: int(c.max()) for k, c in cnts.items()},
                                                     {k: float(c.sum()) / w.size for k, c in cnts.items()}))
    if form == "group":
        return group_prep(col, force_w4={k: _row_width(int((w >= k).reshape(-1, GROUP).sum(axis=1).max()))
                                         for k in present})
    raise ValueError(f"form must be tile, group or plane, got {form!r}")


def tile_prep(col: EncodedColumn, force_s: dict | None = None) -> dict | None:
    """The tile form: ``trow{k}: (ng, 64*s_k) uint32`` rows in the T8
    layout (each 128-word block packs 512 consecutive bytes as 4 byte
    positions of 128), tile t's bytes front-compacted at byte ``t*s_k``.
    None when the tight strides' padding would exceed PAD_CAP.
    ``force_s`` ({plane: s}) pins the strides and the plane set and skips
    the cap."""
    plane_lens = col.params["plane_lens"]
    ng = num_groups(col.n)
    n_pad = ng * GROUP
    if force_s is not None:
        present = sorted(force_s)
    else:
        present = [k for k in (1, 2, 3) if plane_lens[k] > 0]
    streams = {"widths": col.streams["widths"], "plane0": col.streams["plane0"]}
    if not present:
        return streams
    w = _width_codes(col)
    cnts = _tile_counts(w, present)
    if force_s is not None:
        strides = force_s
    else:
        strides = choose_strides(
            {k: int(cnts[k].max()) for k in present},
            {k: float(cnts[k].sum()) / n_pad for k in present},
        )
    ragged = 1 if col.n < n_pad else 0  # the tail group's write is padded anyway
    if force_s is None:
        # the cap judges the tight strides, from the counts alone
        full_tiles = (ng - ragged) * TPG
        total_pad = 0
        for k in present:
            cnt = cnts[k]
            tail_real = int(cnt[full_tiles:].sum())
            total_pad += full_tiles * _stride_for(int(cnt.max())) - (int(cnt.sum()) - tail_real)
        if total_pad > PAD_CAP * (ng * GROUP * 4):
            return None
    for k in present:
        cnt = cnts[k]
        total = int(cnt.sum())
        s = strides[k]
        assert int(cnt.max()) <= s, (k, int(cnt.max()), s)
        mat = np.zeros(ng * TPG * s, np.uint32)
        if total:
            sel = np.flatnonzero(w >= k)
            tile_of = sel >> 7
            excl = np.cumsum(cnt) - cnt
            r = np.arange(total, dtype=np.int64) - excl[tile_of]
            mat[tile_of * s + r] = _plane_bytes(col, k, total)
        m4 = mat.reshape(ng, TPG * s // 512, 4, TILE)
        words = (
            m4[:, :, 0]
            | (m4[:, :, 1] << np.uint32(8))
            | (m4[:, :, 2] << np.uint32(16))
            | (m4[:, :, 3] << np.uint32(24))
        )
        streams[f"trow{k}"] = np.ascontiguousarray(words.reshape(ng, TPG * s // 4))
    return streams


def global_tile_s(tile_counts: dict, *, ragged: bool = False) -> dict | None:
    """Slice-stable strides for ``tile_prep(force_s=...)`` from whole-column
    per-tile counts, or None over PAD_CAP; ``ragged`` exempts the final
    group's tiles from the cap, as tile_prep does."""
    live = {k: cnt for k, cnt in tile_counts.items() if int(cnt.sum())}
    total_pad = 0
    n_tiles = 0
    for k, cnt in live.items():
        n_tiles = cnt.shape[0]
        full = n_tiles - (TPG if ragged else 0)
        total_pad += full * _stride_for(int(cnt.max())) - int(cnt[:full].sum())
    if n_tiles and total_pad > PAD_CAP * (n_tiles * TILE * 4):
        return None
    return choose_strides(
        {k: int(cnt.max()) for k, cnt in live.items()},
        {k: float(cnt.sum()) / (n_tiles * TILE) for k, cnt in live.items()},
    )


def group_prep(col: EncodedColumn, force_w4: dict | None = None) -> dict | None:
    """The group-row form: ``prow{k}: (ng, w4_k*1024) uint32``, each group's
    bytes front-compacted and packed LMP(8) (byte m of group g at slot
    m // 1024, lane m % 1024). None when padding would exceed PAD_CAP.
    ``force_w4`` ({plane: w4}) pins the row widths and the plane set and
    skips the cap."""
    plane_lens = col.params["plane_lens"]
    ng = num_groups(col.n)
    n_pad = ng * GROUP
    if force_w4 is not None:
        present = sorted(force_w4)
    else:
        present = [k for k in (1, 2, 3) if plane_lens[k] > 0]
    streams = {"widths": col.streams["widths"], "plane0": col.streams["plane0"]}
    if not present:
        return streams
    w = _width_codes(col)
    prows = {}
    total_pad = 0
    ragged = 1 if col.n < n_pad else 0  # the tail group is exempt from the cap
    for k in present:
        cnt = (w >= k).reshape(ng, GROUP).sum(axis=1)
        total = int(cnt.sum())  # trust the widths, as tile_prep does
        max_cnt = int(cnt.max())
        w4 = force_w4[k] if force_w4 else _row_width(max_cnt)
        assert max_cnt <= w4 * 4 * LANES, (k, max_cnt, w4)
        full = ng - ragged
        total_pad += full * w4 * 4 * LANES - (total - int(cnt[-1]) * ragged)
        off = np.zeros(ng, np.int64)
        np.cumsum(cnt[:-1], out=off[1:])
        plane = _plane_bytes(col, k, total)
        mat = np.zeros(ng * GROUP, np.uint32)
        dst = (
            np.repeat(np.arange(ng, dtype=np.int64) * GROUP, cnt)
            + np.arange(total, dtype=np.int64)
            - np.repeat(off, cnt)
        )
        mat[dst] = plane
        prows[f"prow{k}"] = np.ascontiguousarray(lmp_pack(mat, 8)[:, : w4 * LANES])
    if force_w4 is None and total_pad > PAD_CAP * (ng * GROUP * 4):
        return None
    streams.update(prows)
    return streams


def global_w4(counts: dict) -> dict | None:
    """Slice-stable row widths for ``group_prep(force_w4=...)`` from
    whole-column per-group counts, or None over PAD_CAP."""
    w4s = {}
    total_pad = 0
    ng = 0
    for k, cnt in counts.items():
        if int(cnt.sum()) == 0:
            continue
        ng = cnt.shape[0]
        w4s[k] = _row_width(int(cnt.max()))
        total_pad += ng * w4s[k] * 4 * LANES - int(cnt.sum())
    if ng and total_pad > PAD_CAP * (ng * GROUP * 4):
        return None
    return w4s


def prep(col: EncodedColumn) -> dict:
    """The device streams of a dzbv column: the tile form, else the
    group-row form, else the on-disk planes; streams already in a
    re-anchored form pass through."""
    for k in (1, 2, 3):
        if f"trow{k}" in col.streams or f"prow{k}" in col.streams:
            return col.streams
    pre = tile_prep(col)
    if pre is None:
        pre = group_prep(col)
    return pre if pre is not None else col.streams


def _check_base(widths: torch.Tensor, plane0: torch.Tensor, out_dtype: torch.dtype) -> int:
    """Validate the width codes (LMP(2)) and plane 0 (LMP(8)); returns ng."""
    _wrap.check_out_dtype(out_dtype)
    ng = _wrap.check_rows(widths, "widths", 2 * LANES)
    _wrap.check_rows(plane0, "plane0", 8 * LANES)
    if plane0.shape[0] != ng or plane0.device != widths.device:
        raise ValueError(f"plane0 {tuple(plane0.shape)} on {plane0.device} does not match "
                         f"widths {tuple(widths.shape)} on {widths.device}")
    return ng


def _check_planes(planes: tuple, name: str, ng: int | None, device: torch.device, widths) -> None:
    """Validate the streams of planes 1..3 (None where a plane is absent):
    int32 rows of one of ``widths`` words, ng rows when ng is given."""
    if not isinstance(planes, (tuple, list)) or len(planes) != 3:
        raise ValueError(f"{name}s must be three streams (planes 1..3, None where absent), got {planes!r}")
    for k, t in enumerate(planes, 1):
        if t is None:
            continue
        rows = _wrap.check_rows(t, f"{name}{k}")
        if t.shape[1] not in widths or (ng is not None and rows != ng) or t.device != device:
            raise ValueError(f"no dzbv kernel for {name}{k} {tuple(t.shape)} on {t.device}: wants "
                             f"{ng or 'any'} rows of {sorted(widths)} words on {device}")


_TROW_WORDS = {64 * s for s in range(STRIDE_Q, TILE + 1, STRIDE_Q)}  # s_k = 8, 16, ..., 128
_PROW_WORDS = {w4 * LANES for w4 in range(1, 9)}


def _launch(name: str, widths: torch.Tensor, plane0: torch.Tensor, planes: tuple, shape_of, out_dtype: torch.dtype,
            ranks: tuple = ()) -> torch.Tensor:
    """Launch kernel ``name`` (gt_<name> of csrc/dzbv_decode.cu) on checked
    CUDA tensors: each plane's stream and ``shape_of(stream)``, None and 0
    where the plane is absent, and K15's ``ranks`` (offsets, counts). Every
    form stages its plane bytes with bulk copies, which need 16-byte aligned
    streams."""
    _wrap.check_aligned({f"plane {k} rows": t for k, t in enumerate(planes, 1)})
    ng = widths.shape[0]
    out = _wrap.empty_out(ng, out_dtype, widths.device)
    _wrap.launch(
        f"gt_{name}", widths.device, widths.data_ptr(), plane0.data_ptr(),
        *(None if t is None else t.data_ptr() for t in planes),
        *(0 if t is None else shape_of(t) for t in planes),
        *(t.data_ptr() for t in ranks),
        out.data_ptr(), ng, _wrap.OUT_BYTES[out_dtype],
    )
    LAUNCHES[name] += 1
    return out


def dzbv_tile_decode(widths: torch.Tensor, plane0: torch.Tensor, trows: tuple, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(ng, 2048) width codes, (ng, 8192) plane 0 and the tile form's
    ``trows`` ((ng, 64*s_k) or None, planes 1..3) -> (ng, GROUP) of out_dtype."""
    ng = _check_base(widths, plane0, out_dtype)
    _check_planes(trows, "trow", ng, widths.device, _TROW_WORDS)
    if widths.device.type == "cpu":
        return lanes.dzbv_tile_decode(widths, plane0, trows, out_dtype)
    return _launch("dzbv_tile_decode", widths, plane0, trows, lambda t: t.shape[1] // 64, out_dtype)


def dzbv_group_decode(widths: torch.Tensor, plane0: torch.Tensor, prows: tuple, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(ng, 2048) width codes, (ng, 8192) plane 0 and the group-row form's
    ``prows`` ((ng, w4_k*1024) or None, planes 1..3) -> (ng, GROUP)."""
    ng = _check_base(widths, plane0, out_dtype)
    _check_planes(prows, "prow", ng, widths.device, _PROW_WORDS)
    if widths.device.type == "cpu":
        return lanes.dzbv_group_decode(widths, plane0, prows, out_dtype)
    return _launch("dzbv_group_decode", widths, plane0, prows, lambda t: t.shape[1] // LANES, out_dtype)


def dzbv_plane_decode(widths: torch.Tensor, plane0: torch.Tensor, planes: tuple, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(ng, 2048) width codes, (ng, 8192) plane 0 and the on-disk
    ``planes`` ((rows_k, 8192) LMP(8) or None, planes 1..3) -> (ng, GROUP).
    On a CUDA device: K15's count kernel gives each group's counts, (3, ng)
    so that the exclusive torch cumsum over the groups runs along rows
    (along columns torch scans each column in one thread), that cumsum
    their int64 offsets, and K15's decode stages each group's window of
    every plane from its offset and count and ranks into it; one launch of
    K15 in the count."""
    ng = _check_base(widths, plane0, out_dtype)
    _check_planes(planes, "plane", None, widths.device, {8 * LANES})
    if widths.device.type == "cpu":
        return lanes.dzbv_plane_decode(widths, plane0, planes, out_dtype)
    counts = torch.empty((3, ng), dtype=torch.int32, device=widths.device)
    _wrap.launch("gt_dzbv_plane_counts", widths.device, widths.data_ptr(), counts.data_ptr(), ng)
    offsets = torch.cumsum(counts, 1, dtype=torch.int64) - counts
    return _launch("dzbv_plane_decode", widths, plane0, planes, lambda t: t.shape[0], out_dtype, (offsets, counts))


def kernel_call(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple[str, tuple]:
    """(kernel name, wrapper arguments) that decode ``col`` from its
    prepped streams, by stream form as the reference's ``build`` picks:
    on-disk planes -> K15, ``prow*`` -> K14, ``trow*`` or no plane above 0
    -> K13."""
    base = (streams["widths"], streams["plane0"])
    if any(f"plane{k}" in streams for k in (1, 2, 3)):
        lens = col.params["plane_lens"]
        planes = tuple(streams[f"plane{k}"] if lens[k] > 0 else None for k in (1, 2, 3))
        return "dzbv_plane_decode", (*base, planes, out_store)
    if any(f"prow{k}" in streams for k in (1, 2, 3)) and not any(f"trow{k}" in streams for k in (1, 2, 3)):
        return "dzbv_group_decode", (*base, tuple(streams.get(f"prow{k}") for k in (1, 2, 3)), out_store)
    return "dzbv_tile_decode", (*base, tuple(streams.get(f"trow{k}") for k in (1, 2, 3)), out_store)


_WRAPPERS = {"dzbv_tile_decode": dzbv_tile_decode, "dzbv_group_decode": dzbv_group_decode,
             "dzbv_plane_decode": dzbv_plane_decode}



_FORMS = {"dzbv_tile_decode": 0, "dzbv_group_decode": 1, "dzbv_plane_decode": 2}  # gt::DzbvForm


def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launches of kernel ``name`` on ``args``, for roofline.ops_audit:
    ``dzbv_staged_kernel<T, DzbvForm, P>`` (P the highest plane present), a
    block of 1024 threads a group, and for K15 first its count kernel (the
    torch cumsum between them is no kernel of the port's). For each plane
    below P, warp 0 stages the group's row in 2 KB bulk copies, a turn of
    ``for (b = lane * 2048; b < bytes; b += 64 KB)`` and in each turn a
    loop over the lanes that start a copy (its operands must be
    warp-uniform); then phase 1's rolled loop of 8 turns (``#pragma unroll
    1``, four slots a turn) and the rotation of the staged 4 KB (K13: 512 B)
    blocks, a turn a block for each team of 8 warps (K13: of one). K15's
    windows, and so the bytes of its copies and its rotation, are data."""
    widths, _plane0, planes, out_dtype = _wrap.bind(_WRAPPERS[name], args).values()
    form = _FORMS[name]
    top = max((k + 1 for k, t in enumerate(planes) if t is not None), default=0)
    ng = widths.shape[0]
    trips: tuple = ()
    if top and form == 2:
        trips = (None, None) * top + (8, None)
    elif top:
        bytes_ = [0 if t is None else t.shape[1] * 4 for t in planes[:top]]
        for b in bytes_:
            turns = math.ceil(b / 65536)
            trips += (turns / 32, b / 2048 / turns) if turns else (0, 0)
        block, teams = (512, 32) if form == 0 else (4096, 4)
        total = sum(bytes_)
        rotate = sum(max(0, math.ceil((total - t * block) / (teams * block))) for t in range(teams)) / teams
        trips += (8, rotate)
    kernel = f"gt::dzbv_staged_kernel<{_wrap.T_NAME[out_dtype]}, (gt::DzbvForm){form}, (int){top}>"
    decode = _wrap.Launch(kernel, ng * LANES, trips)
    return [_wrap.Launch("gt::dzbv_plane_counts_kernel", ng * LANES), decode] if form == 2 else [decode]

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    def decode(streams):
        name, args = kernel_call(col, streams, out_store)
        return _WRAPPERS[name](*args).reshape(-1)

    return decode


registry.register_device("dzbv", build, prep, narrow_store=True)
