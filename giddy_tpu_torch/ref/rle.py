"""Run-length encoding — host codec (FORMAT.md §1.5; BASELINE configs[3]).

The port's copy of giddy_tpu/ref/rle.py. Runs are split at GROUP
boundaries and padded to a fixed per-group stride ``r_pad``, so every
group owns a self-contained run table: pad runs repeat the group's last
real value and end at the GROUP sentinel.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, dtype_to_u32, next_power_of_2, num_groups, u32_to_dtype


def _runs_per_group(values: np.ndarray):
    """Shared by rle/rpe: split runs at group boundaries.

    Returns (ng, run_values, run_starts_within_group, group_of_run,
    rank_of_run_within_group, counts_per_group). Input must be padded.
    """
    v = values
    n_pad = v.shape[0]
    ng = n_pad // GROUP
    change = np.nonzero(np.diff(v))[0] + 1
    gb = np.arange(1, ng, dtype=np.int64) * GROUP
    starts = np.union1d(np.concatenate(([0], change)), gb).astype(np.int64)
    vals = v[starts]
    grp = starts // GROUP
    counts = np.bincount(grp, minlength=ng)
    first = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rank = np.arange(starts.shape[0], dtype=np.int64) - first[grp]
    return ng, vals, (starts - grp * GROUP), grp, rank, counts


def padded_payload(values: np.ndarray) -> np.ndarray:
    """uint32 payloads padded to whole groups by repeating the last value
    (one all-zero group for an empty column)."""
    n = values.shape[0]
    u = dtype_to_u32(values)
    if n and n % GROUP:
        pad = np.full(num_groups(n) * GROUP - n, u[-1], dtype=u.dtype)
        u = np.concatenate([u, pad])
    elif not n:
        u = np.zeros(GROUP, dtype=np.uint32)
    return u


def run_tables(values: np.ndarray):
    """(run_values (ng, r_pad) int32 with pad runs repeating the last real
    value, run starts within the group, group and rank of each real run,
    counts per group, r_pad) — the part rle and rpe share."""
    ng, vals, starts_wg, grp, rank, counts = _runs_per_group(padded_payload(values))
    r_pad = max(8, next_power_of_2(int(counts.max())))
    run_values = np.zeros((ng, r_pad), dtype=np.int32)
    run_values[grp, rank] = vals.view(np.int32)
    last_val = run_values[np.arange(ng), counts - 1]
    pad_mask = np.arange(r_pad)[None, :] >= counts[:, None]
    run_values = np.where(pad_mask, last_val[:, None], run_values)
    return run_values, starts_wg, grp, rank, counts, r_pad


def encode(values: np.ndarray, *, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    run_values, starts_wg, grp, rank, counts, r_pad = run_tables(values)
    ng = counts.shape[0]
    run_ends = np.full((ng, r_pad), GROUP, dtype=np.int32)
    # ends = next run's start within group; last real run of a group ends at GROUP
    ends_wg = np.empty_like(starts_wg)
    ends_wg[:-1] = np.where(grp[:-1] == grp[1:], starts_wg[1:], GROUP)
    ends_wg[-1] = GROUP
    run_ends[grp, rank] = ends_wg.astype(np.int32)
    return EncodedColumn(
        name=name,
        scheme="rle",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={"r_pad": int(r_pad)},
        streams={
            "run_values": run_values.reshape(-1),
            "run_ends": run_ends.reshape(-1),
            "run_counts": counts.astype(np.int32),
        },
    )


def expand(col: EncodedColumn, bounds_key: str, shift: int) -> np.ndarray:
    """Oracle run expansion: value of run #{bounds <= j} + shift at every
    position j of every group."""
    r_pad = col.params["r_pad"]
    ng = num_groups(col.n)
    vals = col.streams["run_values"].reshape(ng, r_pad)
    bounds = col.streams[bounds_key].reshape(ng, r_pad)
    out = np.empty((ng, GROUP), dtype=np.uint32)
    j = np.arange(GROUP)
    for g in range(ng):
        r = np.searchsorted(bounds[g], j, side="right") + shift
        out[g] = vals[g, r].view(np.uint32)
    return u32_to_dtype(out.reshape(-1)[: col.n], col.dtype)


def decode(col: EncodedColumn) -> np.ndarray:
    return expand(col, "run_ends", 0)


registry.register("rle", encode, decode)
