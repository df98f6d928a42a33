"""Column metadata + container format (FORMAT.md §2), for the PyTorch port.

The same :class:`EncodedColumn` and the same container bytes as
giddy_tpu/format.py (FORMAT.md is shared, not forked); the CPU tests hold
the two byte for byte. :func:`from_reference` carries a column encoded by
the JAX package across without importing it.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, BinaryIO, Mapping

import numpy as np

MAGIC = b"GIDDYTP1"
ALIGN = 64


@dataclasses.dataclass
class EncodedColumn:
    """One encoded column: static metadata + named binary streams."""

    name: str
    scheme: str
    dtype: str  # logical element dtype name, e.g. "int32"
    n: int  # logical (unpadded) element count
    params: dict[str, Any]  # scheme params; JSON-able
    streams: dict[str, np.ndarray]

    @property
    def nbytes_compressed(self) -> int:
        return sum(s.nbytes for s in self.streams.values())

    @property
    def nbytes_decoded(self) -> int:
        return self.n * np.dtype(self.dtype).itemsize

    @property
    def ratio(self) -> float:
        return self.nbytes_decoded / max(self.nbytes_compressed, 1)

    def static_key(self) -> tuple:
        """Hashable key capturing everything that selects a decoder."""
        return (
            self.scheme,
            self.dtype,
            self.n,
            json.dumps(self.params, sort_keys=True),
            tuple(sorted((k, v.shape, str(v.dtype)) for k, v in self.streams.items())),
        )


def from_reference(col) -> EncodedColumn:
    """The port's column for a ``giddy_tpu.format.EncodedColumn`` (or any
    object with the same attributes): metadata and streams are copied by
    value, the streams as NumPy arrays."""
    return EncodedColumn(
        name=col.name,
        scheme=col.scheme,
        dtype=col.dtype,
        n=int(col.n),
        params=json.loads(json.dumps(col.params)),
        streams={k: np.asarray(v) for k, v in col.streams.items()},
    )


def _align(pos: int) -> int:
    return (pos + ALIGN - 1) // ALIGN * ALIGN


def write_container(columns: list[EncodedColumn], fp: BinaryIO) -> None:
    header: dict[str, Any] = {"columns": []}
    # First pass: lay out blob offsets.
    blobs: list[np.ndarray] = []
    pos = 0  # relative to blob area start; fixed up after header is sized
    entries = []
    for col in columns:
        streams_meta = {}
        for sname, arr in col.streams.items():
            arr = np.ascontiguousarray(arr)
            pos = _align(pos)
            streams_meta[sname] = {
                "offset": pos,
                "nbytes": arr.nbytes,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
            }
            blobs.append(arr)
            pos += arr.nbytes
        entries.append(
            {
                "name": col.name,
                "scheme": col.scheme,
                "dtype": col.dtype,
                "n": col.n,
                "params": col.params,
                "streams": streams_meta,
            }
        )
    header["columns"] = entries
    hjson = json.dumps(header).encode("utf-8")
    blob_start = _align(len(MAGIC) + 8 + len(hjson))
    # Make offsets absolute.
    for e in entries:
        for m in e["streams"].values():
            m["offset"] += blob_start
    hjson = json.dumps(header).encode("utf-8")
    # Re-derive blob_start with the (possibly longer) absolute-offset JSON;
    # iterate until stable (at most a few rounds — offsets only grow).
    while _align(len(MAGIC) + 8 + len(hjson)) != blob_start:
        delta = _align(len(MAGIC) + 8 + len(hjson)) - blob_start
        blob_start += delta
        for e in entries:
            for m in e["streams"].values():
                m["offset"] += delta
        hjson = json.dumps(header).encode("utf-8")

    fp.write(MAGIC)
    fp.write(len(hjson).to_bytes(8, "little"))
    fp.write(hjson)
    fp.write(b"\0" * (blob_start - (len(MAGIC) + 8 + len(hjson))))
    pos = blob_start
    for arr in blobs:
        pad = _align(pos) - pos
        if pad:
            fp.write(b"\0" * pad)
            pos += pad
        fp.write(arr.tobytes())
        pos += arr.nbytes


def read_container(data: bytes | Mapping) -> list[EncodedColumn]:
    if not isinstance(data, (bytes, bytearray, memoryview)):
        data = data.read()
    buf = memoryview(data)
    if len(buf) < 16:
        raise ValueError(f"truncated container: {len(buf)} bytes, need at least 16")
    if bytes(buf[:8]) != MAGIC:
        raise ValueError("bad magic; not a giddy-tpu container")
    hlen = int.from_bytes(bytes(buf[8:16]), "little")
    if 16 + hlen > len(buf):
        raise ValueError(
            f"truncated container: header claims {hlen} bytes, file holds {len(buf) - 16}"
        )
    try:
        header = json.loads(bytes(buf[16 : 16 + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"corrupt container header: {exc}") from None
    if "columns" not in header:
        raise ValueError("corrupt container: header lacks a 'columns' list")
    cols = []
    for e in header["columns"]:
        streams = {}
        for sname, m in e["streams"].items():
            if not isinstance(m.get("dtype"), str):
                raise ValueError(
                    f"corrupt container: stream {e.get('name')}/{sname} has "
                    f"invalid dtype {m.get('dtype')!r}"
                )
            try:
                dt = np.dtype(m["dtype"])
            except TypeError:
                raise ValueError(
                    f"corrupt container: stream {e.get('name')}/{sname} has "
                    f"invalid dtype {m.get('dtype')!r}"
                ) from None
            if any(int(s) < 0 for s in m["shape"]):
                raise ValueError(
                    f"corrupt container: stream {e.get('name')}/{sname} has "
                    f"negative shape {m['shape']}"
                )
            count = int(np.prod(m["shape"], dtype=np.int64)) if m["shape"] else 1
            off = int(m["offset"])
            if off < 0 or off + count * dt.itemsize > len(buf):
                raise ValueError(
                    f"corrupt container: stream {e.get('name')}/{sname} "
                    f"[{off}, {off + count * dt.itemsize}) exceeds file size {len(buf)}"
                )
            streams[sname] = np.frombuffer(buf, dtype=dt, count=count, offset=off).reshape(m["shape"])
        cols.append(
            EncodedColumn(
                name=e["name"],
                scheme=e["scheme"],
                dtype=e["dtype"],
                n=e["n"],
                params=e["params"],
                streams=streams,
            )
        )
    return cols


def container_bytes(columns: list[EncodedColumn]) -> bytes:
    bio = io.BytesIO()
    write_container(columns, bio)
    return bio.getvalue()


def open_container(path: str) -> list[EncodedColumn]:
    """Zero-copy container open: mmap the file; stream arrays are views
    into the mapping (64-byte-aligned offsets, FORMAT.md §2)."""
    import mmap

    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return read_container(memoryview(mm))
