"""RLE / RPE decode: kernel K5 (csrc/run_decode.cu ``run_strip_kernel``),
or a scatter-add and kernel K6 (kernels/cumsum.py) for dense runs.

Counterpart of giddy_tpu/kernels/rle.py. The host prep is the reference's,
byte for byte at its default constants: it re-splits each group's run
table into per-tile tables of ``w_pad`` runs (the tile form, ``vals_w`` /
``ends_w``), or, when runs are too dense for that, into scatter pairs (the
scatter form, ``pos`` / ``dv``). The tile form decodes in one pass of K5;
the scatter form scatter-adds each run's value jump onto its start (a
torch op, plain XLA in the reference) and K6 takes the per-group cumsum.
rle and rpe share the prep and the decoder: both normalise to run ends.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, next_power_of_2, num_groups
from . import _wrap, cumsum, lanes

# The reference's tile-width chooser (giddy_tpu/kernels/rle.py:45-62), at
# its default constants: it decides which stream form the device sees, so
# it stays as it is. CHAIN_HARD also bounds K5's run tables.
CHAIN_HARD = 128
RANK_MIN = 16
RANK_OPS = 37.0
CHAIN_OPS_PER_RUN = 2.0
OPS_PER_BYTE = 4.6
_W_CANDIDATES = (GROUP, 16384, 8192, 4096, 2048, 1024, 512)
MAX_TILES = GROUP // _W_CANDIDATES[-1]

LAUNCHES = 0
# K5's launches by form, as the reference splits its two calls: "chain"
# (w_pad <= RANK_MIN, _chain_call) and "rank" (_rank_call). One kernel
# serves both; each launch counts in LAUNCHES too.
FORM_LAUNCHES = {"chain": 0, "rank": 0}


def form(w_pad: int) -> str:
    """K5's form for tables of ``w_pad`` runs."""
    return "rank" if w_pad > RANK_MIN else "chain"


def _tile_counts(starts, valid, W: int, T: int):
    """Runs overlapping each W-tile: (#run starts inside the tile) + 1 for
    the run spanning in from the previous tile (0 if a run starts exactly
    at the tile boundary)."""
    ng = starts.shape[0]
    tidx = np.arange(ng)[:, None] * T + starts // W
    counts = np.bincount(tidx[valid], minlength=ng * T)
    at_bound = np.zeros(ng * T, bool)
    at_bound[tidx[valid & (starts % W == 0)]] = True
    return counts + ~at_bound


def tile_prep(run_values, bounds, *, positions: bool):
    """Per-GROUP run tables -> per-W-tile tables.

    Returns ``{"vals_w": (ng, T, w_pad) uint32, "ends_w": (ng, T, w_pad)
    int32}``, or None when the runs are too dense for ``CHAIN_HARD`` runs
    per tile even at the smallest tile width (the caller then takes
    :func:`scatter_prep`). ``ends_w`` are tile-relative exclusive ends in
    [0, W]; runs beyond the tile clip to the sentinel W. ``bounds`` is the
    column's run_ends (rle) or run_starts (rpe).
    """
    ng, r_pad = bounds.shape
    vals = run_values.view(np.uint32)
    if positions:
        starts = bounds.astype(np.int64)
        ends = np.concatenate([starts[:, 1:], np.full((ng, 1), GROUP, np.int64)], axis=1)
    else:
        ends = bounds.astype(np.int64)
        starts = np.concatenate([np.zeros((ng, 1), np.int64), ends[:, :-1]], axis=1)
    valid = starts < GROUP  # pad runs start at the GROUP sentinel

    # W: least modelled cost = expansion ops + run-table re-read traffic
    chosen = None
    best_cost = None
    for W in _W_CANDIDATES:
        T = GROUP // W
        counts = _tile_counts(starts, valid, W, T)
        w_pad = max(8, next_power_of_2(int(counts.max())))
        if w_pad > CHAIN_HARD:
            continue
        if RANK_MIN < w_pad <= 128:
            expand = min(RANK_OPS, CHAIN_OPS_PER_RUN * w_pad)
        else:
            expand = CHAIN_OPS_PER_RUN * w_pad
        cost = expand + (T * w_pad * 8 / GROUP) * OPS_PER_BYTE
        if best_cost is None or cost < best_cost:
            chosen, best_cost = (W, T, w_pad), cost
    if chosen is None:
        return None
    W, T, w_pad = chosen

    # First run covering each tile: lo[g,t] = #(ends <= t*W); real ends are
    # strictly increasing, pad ends equal GROUP (bin T, inert for t < T).
    te = -(-ends // W)  # run r is fully before tile t iff ceil(end/W) <= t
    hist = np.zeros((ng, T + 1), np.int64)
    np.add.at(hist, (np.arange(ng)[:, None], np.minimum(te, T)), 1)
    lo = np.cumsum(hist, axis=1)[:, :T]
    idx = lo[:, :, None] + np.arange(w_pad)[None, None, :]
    np.clip(idx, 0, r_pad - 1, out=idx)
    g_ix = np.arange(ng)[:, None, None]
    vals_w = vals[g_ix, idx]
    rel = ends[g_ix, idx] - (np.arange(T, dtype=np.int64) * W)[None, :, None]
    ends_w = np.clip(rel, 0, W).astype(np.int32)
    return {"vals_w": vals_w, "ends_w": ends_w}


def scatter_prep(run_values, bounds, *, positions: bool, ng_local: int | None = None) -> dict:
    """Run tables -> (pos, dv) scatter pairs.

    pos = shard-local flat position of each run start (pad runs land on the
    sentinel GROUP, i.e. the next group's position 0, or past the end for
    the last group; their value jump dv is 0 by the padding rules).
    dv = value jump at each start (uint32 wrap); cumsum(scatter(pos, dv))
    reconstructs the column.
    """
    ng, r_pad = bounds.shape
    ng_local = ng if ng_local is None else ng_local
    if positions:
        starts = bounds.astype(np.int64)
    else:
        starts = np.concatenate([np.zeros((ng, 1), np.int64), bounds[:, :-1].astype(np.int64)], axis=1)
    vals = run_values.view(np.uint32)
    prev = np.concatenate([np.zeros((ng, 1), np.uint32), vals[:, :-1]], axis=1)
    dv = vals - prev
    g_local = (np.arange(ng, dtype=np.int64) % ng_local).reshape(ng, 1)
    pos = (g_local * GROUP + starts).astype(np.int32)
    return {"pos": pos, "dv": dv}


def prep(col: EncodedColumn, *, positions: bool) -> dict:
    """The device streams of an rle (positions=False) or rpe column."""
    if "vals_w" in col.streams or "pos" in col.streams:
        return col.streams  # already in tile / scatter form
    r_pad = col.params["r_pad"]
    ng = num_groups(col.n)
    bounds = col.streams["run_starts" if positions else "run_ends"].reshape(ng, r_pad)
    vals = col.streams["run_values"].reshape(ng, r_pad)
    pre = tile_prep(vals, bounds, positions=positions)
    return pre if pre is not None else scatter_prep(vals, bounds, positions=positions)


def run_expand(ends_w: torch.Tensor, vals_w: torch.Tensor, ng: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    """Tile-form run tables (ng*T, w_pad) int32 -> (ng, GROUP) of out_dtype
    (the run values mapped through ``lut`` when given).

    Group g owns tables g*T .. g*T+T-1, each covering W = GROUP/T positions;
    T (<= 64) and w_pad (<= CHAIN_HARD) are powers of two."""
    global LAUNCHES
    _wrap.check_out_dtype(out_dtype)
    rows = _wrap.check_rows(ends_w, "ends_w")
    w_pad = ends_w.shape[1]
    _wrap.check_rows(vals_w, "vals_w", w_pad)
    if vals_w.shape[0] != rows or vals_w.device != ends_w.device:
        raise ValueError(f"vals_w {tuple(vals_w.shape)} on {vals_w.device} does not match "
                         f"ends_w {tuple(ends_w.shape)} on {ends_w.device}")
    tiles = rows // ng if isinstance(ng, int) and ng >= 1 and rows % ng == 0 else 0
    if tiles not in {GROUP // w for w in _W_CANDIDATES} or w_pad & (w_pad - 1) or w_pad > CHAIN_HARD:
        raise ValueError(f"no run-expand kernel for {rows} tables of {w_pad} runs over {ng} groups: "
                         f"wants T = rows/ng a power of two <= {MAX_TILES} and w_pad a power of two "
                         f"<= {CHAIN_HARD}")
    table = _wrap.lut_args(lut, ends_w.device)
    if ends_w.device.type == "cpu":
        return lanes.run_expand(ends_w, vals_w, ng, out_dtype, lut)
    vector = 4 * max(1, w_pad // 32)  # bytes a lane of K5 loads at once
    for name, t in (("ends_w", ends_w), ("vals_w", vals_w)):
        if t.data_ptr() % vector:
            raise ValueError(f"{name} must be {vector}-byte aligned for K5's vector loads at w_pad {w_pad}, "
                             f"got address {t.data_ptr():#x}")
    out = _wrap.empty_out(ng, out_dtype, ends_w.device)
    w_shift = (GROUP // tiles).bit_length() - 1
    _wrap.launch(
        "gt_run_expand", ends_w.device, ends_w.data_ptr(), vals_w.data_ptr(), out.data_ptr(),
        ng, w_shift, w_pad, _wrap.OUT_BYTES[out_dtype], *table,
    )
    LAUNCHES += 1
    FORM_LAUNCHES[form(w_pad)] += 1
    return out


def scatter_dense(pos: torch.Tensor, dv: torch.Tensor, ng: int) -> torch.Tensor:
    """Scatter-add of the value jumps dv onto positions pos -> (ng, GROUP)
    int32 rows (the reference's ``dense.at[pos].add(dv, mode="drop")``).
    A pair outside [0, ng*GROUP) (the last group's pad sentinels) lands in
    a spare slot past the end and is dropped, so nothing synchronises."""
    n = ng * GROUP
    p = pos.reshape(-1)
    p = torch.where((p >= 0) & (p < n), p, n)
    dense = torch.zeros(n + 1, dtype=torch.int32, device=pos.device)
    dense.index_add_(0, p, dv.reshape(-1))
    return dense[:n].view(ng, GROUP)



def census(name: str, args: tuple) -> list[_wrap.Launch]:
    """The launch of :func:`run_expand` on ``args``, for roofline.ops_audit:
    ``run_strip_kernel<T, LutMode, E>`` (E = max(1, w_pad / 32) entries a
    lane; with a table kGlobal), blocks of 8 warps, a warp per 1024
    positions of a group. Its loops are over positions, not runs: a warp's
    spans (1024 / len of them, len = min(W, 1024) for tiles of W
    positions) and, in each, the strip's steps of 128 positions."""
    a = _wrap.bind(run_expand, args)
    ng, w_pad = a["ng"], a["ends_w"].shape[1]
    span = min(GROUP * ng // a["ends_w"].shape[0], 1024)
    kernel = (f"gt::run_strip_kernel<{_wrap.T_NAME[a['out_dtype']]}, (gt::LutMode){0 if a['lut'] is None else 2}, "
              f"(int){max(1, w_pad // 32)}>")
    return [_wrap.Launch(kernel, ng * 1024, (1024 // span, span // 128))]

def kernel_call(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple[str, tuple]:
    """(kernel name, wrapper arguments) of the kernel that decodes ``col``
    from its prepped streams: K5 for the tile form (a (ng, T, w_pad)
    layout reshapes to rows), K6 on the scattered rows for the scatter form."""
    ng = num_groups(col.n)
    if "vals_w" in streams:
        w_pad = streams["vals_w"].shape[-1]
        return "run_expand", (streams["ends_w"].reshape(-1, w_pad), streams["vals_w"].reshape(-1, w_pad), ng, out_store)
    return "cumsum_rows", (scatter_dense(streams["pos"], streams["dv"], ng), out_store)


def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    wrappers = {"run_expand": run_expand, "cumsum_rows": cumsum.cumsum_rows}

    def decode(streams):
        name, args = kernel_call(col, streams, out_store)
        return wrappers[name](*args).reshape(-1)

    return decode


registry.register_device("rle", build, lambda col: prep(col, positions=False), narrow_store=True)
registry.register_device("rpe", build, lambda col: prep(col, positions=True), narrow_store=True)
