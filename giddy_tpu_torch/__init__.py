"""giddy_tpu_torch: the PyTorch + CUDA port of giddy_tpu.

Decodes the same encoded columns and containers (FORMAT.md) on an NVIDIA
GPU with hand-written CUDA kernels (csrc/), or on the CPU with their plain
PyTorch versions. Imports torch and NumPy, never JAX or giddy_tpu.

Ported so far: decode of nbit, dzbf, for, delta, dict, rle, rpe, delta2,
xordelta, patched, raw, cascade, model, bitmap, alp and dzbv, of 64-bit
columns (``wide``) and string columns (``strings``, scheme ``strdict``),
single columns (``decode``) and whole containers (``decode_columns``),
``scan.group_prefix_sum`` / ``group_reduce``, the synthetic columns of
``datagen``, nullable columns (``nulls``, ``encode(..., valid=mask)``), the
scan layer's filters (``query.count_where`` / ``filter_bitmap`` / ``select``
and the bitmap algebra) and aggregates (``aggregate.sum_`` / ``min_`` /
``max_`` / ``avg_`` / ``distinct_count``), GROUP BY (``groupby``), top-k
(``topk``), zone maps (``zonemap``), random-access decode (``partial``) and
the layout ops (``layout``), the ``Table`` API (``table``), joins
(``join``), partitioned datasets (``dataset``), streamed decode
(``stream``), the scheme advisor (``advisor``, ``encode(v, "auto")``), the
command line (``cli``), a selftest (``selftest``), and the sharded layer
over a mesh of one or more GPUs (``dist.Mesh``, ``dist.decode_sharded``,
the ``dist_query`` scans, ``mesh=`` on joins and datasets). Every entry
point runs on the card unless the caller asks for ``device="cpu"`` (or
passes a mesh of CPU devices).
"""

from . import (
    advisor, aggregate, datagen, dataset, dist, dist_query, groupby, join, layout, nulls, partial, query, scan, stream,
    strings, table, topk, wide, zonemap,
)
from .api import decode, decode_columns, decode_ref, device_streams, encode, get_decoder, narrow_store_dtype, upload
from .dataset import Dataset
from .format import (
    EncodedColumn,
    container_bytes,
    from_reference,
    open_container,
    read_container,
    write_container,
)
from .nulls import count_valid, decode_masked, null_count, valid_mask
from .join import join_indices, join_tables
from .registry import get, schemes
from .table import Table
from .topk import order_by, top_k
from .util import GROUP, LANES, SLOTS

__version__ = "0.1.0"  # giddy_tpu's (pyproject.toml)

__all__ = [
    "Dataset",
    "EncodedColumn",
    "GROUP",
    "LANES",
    "SLOTS",
    "aggregate",
    "container_bytes",
    "count_valid",
    "datagen",
    "decode",
    "decode_columns",
    "decode_masked",
    "decode_ref",
    "device_streams",
    "dist",
    "dist_query",
    "encode",
    "from_reference",
    "get",
    "get_decoder",
    "groupby",
    "layout",
    "narrow_store_dtype",
    "null_count",
    "nulls",
    "open_container",
    "partial",
    "query",
    "read_container",
    "scan",
    "schemes",
    "strings",
    "topk",
    "upload",
    "valid_mask",
    "wide",
    "write_container",
    "zonemap",
]
