"""Run-position encoding — host codec (FORMAT.md §1.6).

The port's copy of giddy_tpu/ref/rpe.py: rle's group-split run tables,
with run start positions (pad starts at the GROUP sentinel) in place of
run ends.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP
from .rle import expand, run_tables


def encode(values: np.ndarray, *, name: str = "col") -> EncodedColumn:
    values = np.asarray(values)
    run_values, starts_wg, grp, rank, counts, r_pad = run_tables(values)
    run_starts = np.full((counts.shape[0], r_pad), GROUP, dtype=np.int32)  # sentinel > any j
    run_starts[grp, rank] = starts_wg.astype(np.int32)
    return EncodedColumn(
        name=name,
        scheme="rpe",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={"r_pad": int(r_pad)},
        streams={
            "run_values": run_values.reshape(-1),
            "run_starts": run_starts.reshape(-1),
            "run_counts": counts.astype(np.int32),
        },
    )


def decode(col: EncodedColumn) -> np.ndarray:
    return expand(col, "run_starts", -1)


registry.register("rpe", encode, decode)
