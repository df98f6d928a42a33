"""The fixed yardstick of the per-layer metrics.

The card's memory rate and the least bytes a kernel launch moves are
frozen here, so that no change to the program moves them.
``least_bytes`` is giddy_tpu_torch.roofline.column_roofline's arithmetic
(the encoded streams read once, the output written once). What a port
kernel writes is data, one file a kernel: ``kernel_bytes/<kernel>.json``
with ``"output"`` either ``"column"`` (the decoded column) or
``"bitmap"`` (one bit a row, in whole groups of 32,768). A kernel added
to the port gets a file of its own; one without a file has no byte count,
and a reader that meets it reports nothing.
"""

from __future__ import annotations

import functools
import json
import pathlib
import re

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s. The benchmark's
# own constant: a share of it is stated beside the card's power limit.
HBM_BYTES_PER_S = 3.35e12

GROUP = 32768  # rows a bitmap group covers (1024 words of 32 bits)

_DIR = pathlib.Path(__file__).resolve().parent / "kernel_bytes"

# The port's kernels live in the C++ namespace gt; the trace names them
# "void gt::<kernel><...>(...)".
_PORT = re.compile(r"\bgt::([A-Za-z_][A-Za-z0-9_]*)")


def port_kernel(name: str) -> str | None:
    """The port kernel's own name in a trace name, None for any other op."""
    m = _PORT.search(name)
    return m.group(1) if m else None


@functools.cache
def output(kernel: str) -> str | None:
    """What one launch of ``kernel`` writes ("column" or "bitmap"), from
    its file; None where it has none."""
    path = _DIR / f"{kernel}.json"
    return json.loads(path.read_text())["output"] if path.is_file() else None


def bitmap_bytes(n: int) -> int:
    return -(-max(n, 1) // GROUP) * GROUP // 8


def least_bytes(kernel: str, stream_bytes: int, n: int, itemsize: int) -> int | None:
    """Bytes one launch of ``kernel`` on a column must move at least: its
    encoded streams read once and its output written once."""
    out = output(kernel)
    if out == "column":
        return stream_bytes + n * itemsize
    if out == "bitmap":
        return stream_bytes + bitmap_bytes(n)
    return None
