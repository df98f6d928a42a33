"""String columns: dictionary-encoded text with predicate pushdown.

Counterpart of giddy_tpu/strings.py (scheme ``strdict``). A column of
strings is a byte-string dictionary (host) plus an int32 code column
(device) encoded with any registered inner scheme, as ``cascade`` is: so
string scans become integer code scans and reuse the whole pipeline (K16
over the codes where the inner scheme is fused, GROUP BY, nullability).

- params: ``codes_scheme``/``codes_params`` (the inner column),
  ``dict_size``, ``kind`` ("str" | "bytes"), ``dense`` (always true: the
  dictionary is built with np.unique, so it is sorted by bytes and every
  entry occurs).
- streams: ``values_bytes`` (uint8, the entries concatenated),
  ``values_offsets`` (int64, d+1 boundaries), and the inner code column's
  streams under a ``c_`` prefix (plus ``valid`` when nullable).

Ordering is bytes order (UTF-8 for str inputs), which is what makes the
ordered predicates and ``startswith`` collapse to at most one contiguous
code range. The codes decode on the card; the string gather runs on the
host, where the strings live. Entry points that touch the card take
``device`` (the card unless ``"cpu"`` is asked).
"""

from __future__ import annotations

import numpy as np
import torch

from . import registry
from .format import EncodedColumn
from .util import LANES, num_groups, sorted_factorize

STR_OPS = ("eq", "ne", "lt", "le", "gt", "ge", "startswith", "contains")

# Inner schemes that "auto" trial-encodes, the smallest kept.
AUTO_INNER = ("rle", "nbit", "delta", "for")


def _to_bytes_list(values) -> tuple[list[bytes], str]:
    out = []
    kind = "bytes"
    for v in values:
        if isinstance(v, str):
            kind = "str"
            out.append(v.encode("utf-8"))
        elif isinstance(v, (bytes, np.bytes_)):
            out.append(bytes(v))
        elif isinstance(v, np.str_):
            kind = "str"
            out.append(str(v).encode("utf-8"))
        else:
            raise TypeError(f"string column values must be str or bytes, got {type(v)}")
    return out, kind


def as_bytes(v) -> bytes:
    """One string value -> utf-8 bytes (the container's key space)."""
    if isinstance(v, (bytes, np.bytes_)):
        return bytes(v)
    if isinstance(v, (str, np.str_)):
        return str(v).encode("utf-8")
    raise TypeError(f"string value must be str or bytes, got {type(v)}")


def _entries(col: EncodedColumn) -> list[bytes]:
    off = col.streams["values_offsets"]
    blob = col.streams["values_bytes"].tobytes()
    return [blob[int(off[i]) : int(off[i + 1])] for i in range(col.params["dict_size"])]


def code_set(col: EncodedColumn, values) -> list[int]:
    """Codes of the dictionary entries matching a value set (utf-8 key space)."""
    want = {as_bytes(v) for v in values}
    return [i for i, e in enumerate(_entries(col)) if e in want]


def encode_strings(values, *, codes_scheme: str = "auto", name: str = "col", valid=None, **codes_opts) -> EncodedColumn:
    """Encode a sequence of str/bytes on the host. ``codes_scheme="auto"``
    trial-encodes the code column with each of AUTO_INNER and keeps the
    smallest. ``valid``: optional bool[n] mask; null rows take the previous
    valid row's code (the nulls.py fill, in code space)."""
    bl, kind = _to_bytes_list(values)
    n = len(bl)
    if n == 0:
        raise ValueError("cannot encode an empty string column")
    arr = np.array(bl, dtype=object)
    mask = None
    if valid is not None:
        from .nulls import fill_nulls

        mask = np.asarray(valid, bool)
        if not mask.any():  # all-null: the canonical fill is the empty string
            arr = np.array([b""] * n, dtype=object)
        else:
            arr = fill_nulls(arr, mask)
    dic, codes = sorted_factorize(arr)
    codes = codes.astype(np.int32)
    if codes_scheme == "auto":
        trials = [registry.get(s).encode(codes, name="_codes") for s in AUTO_INNER]
        ccol = min(trials, key=lambda c: c.nbytes_compressed)
        codes_scheme = ccol.scheme
    else:
        ccol = registry.get(codes_scheme).encode(codes, name="_codes", **codes_opts)
    offsets = np.zeros(dic.shape[0] + 1, np.int64)
    np.cumsum([len(b) for b in dic], out=offsets[1:])
    blob = np.frombuffer(b"".join(dic), dtype=np.uint8).copy() if offsets[-1] else np.zeros(0, np.uint8)
    col = EncodedColumn(
        name=name,
        scheme="strdict",
        dtype="str",  # the logical values never reach the card; see decode()
        n=n,
        params={
            "codes_scheme": codes_scheme,
            "codes_params": ccol.params,
            "dict_size": int(dic.shape[0]),
            "kind": kind,
            "dense": True,
        },
        streams={"values_bytes": blob, "values_offsets": offsets, **{f"c_{k}": v for k, v in ccol.streams.items()}},
    )
    if mask is not None:
        from .nulls import attach_valid

        col = attach_valid(col, mask)
    return col


def dictionary(col: EncodedColumn) -> np.ndarray:
    """The dictionary as an object array of bytes (or str, per ``kind``)."""
    ents = _entries(col)
    if col.params["kind"] == "str":
        return np.array([e.decode("utf-8") for e in ents], dtype=object)
    return np.array(ents, dtype=object)


def codes_column(col: EncodedColumn) -> EncodedColumn:
    """The inner int32 code column. Validity propagates, so every code scan
    is null-correct without outer fixups."""
    streams = {k[2:]: v for k, v in col.streams.items() if k.startswith("c_")}
    params = dict(col.params["codes_params"])
    if col.params.get("nullable") and "valid" in col.streams:
        streams["valid"] = col.streams["valid"]
        params["nullable"] = True
    return EncodedColumn(
        name=f"{col.name}._codes",
        scheme=col.params["codes_scheme"],
        dtype="int32",
        n=col.n,
        params=params,
        streams=streams,
    )


def decode(col: EncodedColumn, *, device: torch.device | str = "cuda") -> np.ndarray:
    """The codes decode on ``device``, the string gather runs on the host.
    Returns an object array; null rows hold the canonical fill."""
    from .api import decode as dev_decode

    codes = dev_decode(codes_column(col), device=device).cpu().numpy()
    return dictionary(col)[codes]


def decode_ref(col: EncodedColumn) -> np.ndarray:
    """NumPy oracle twin of :func:`decode`."""
    ccol = codes_column(col)
    codes = registry.get(ccol.scheme).decode_ref(ccol)
    return dictionary(col)[codes.astype(np.int64)]


def decode_masked_strings(col: EncodedColumn, *, device: torch.device | str = "cuda"):
    from .nulls import valid_mask

    return decode(col, device=device), valid_mask(col)


# --- predicate pushdown -------------------------------------------------------


def _dict_mask(col: EncodedColumn, op: str, value) -> np.ndarray:
    """The predicate over the dictionary (host, O(dict_size))."""
    if op not in STR_OPS:
        raise ValueError(f"op must be one of {STR_OPS}, got {op!r}")
    v = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    fns = {
        "eq": lambda e: e == v, "ne": lambda e: e != v,
        "lt": lambda e: e < v, "le": lambda e: e <= v,
        "gt": lambda e: e > v, "ge": lambda e: e >= v,
        "startswith": lambda e: e.startswith(v),
        "contains": lambda e: v in e,
    }
    return np.fromiter((fns[op](e) for e in _entries(col)), bool, count=col.params["dict_size"])


def _mask_ranges(mask: np.ndarray) -> list[tuple[int, int]]:
    bounds = np.flatnonzero(np.diff(mask.astype(np.int8), prepend=0, append=0))
    return list(zip(bounds[0::2].tolist(), bounds[1::2].tolist()))


def _ranges_bitmap(col: EncodedColumn, ranges, device: torch.device | str = "cuda", *, sharded: bool = False,
                   mesh=None, axis="d"):
    """OR of code-range scans over the inner column (query.filter_bitmap).
    The inner column carries the validity words, so every term is already
    null-masked and the OR stays correct. ``sharded=True``: the scans run
    shard by shard over ``mesh`` (dist_query), and the result is the list
    of (shard, words) of this process's shards."""
    from .groupby import _codes_device_column

    inner = _codes_device_column(col)
    d = col.params["dict_size"]
    if sharded:
        from .dist_query import _filter_words

        def scan(op, v):
            return [w for _, w in _filter_words(inner, op, v, mesh, axis)]
    else:
        from .api import _decode_device
        from .query import filter_bitmap

        device = _decode_device(device)

        def scan(op, v):
            return [filter_bitmap(inner, op, v, device=device)]
    acc = None
    for s, e in ranges:
        if e - s == 1:
            bm = scan("eq", s)
        elif s == 0:
            bm = scan("lt", e)
        elif e == d:
            bm = scan("ge", s)
        else:
            bm = [a & b for a, b in zip(scan("ge", s), scan("lt", e))]
        acc = bm if acc is None else [a | b for a, b in zip(acc, bm)]
    if sharded:
        from .dist_query import _real

        shards = _real(inner, mesh, axis)
        if acc is None:
            acc = [torch.zeros((sh.g1 - sh.g0, LANES), dtype=torch.int32, device=sh.device) for sh in shards]
        return list(zip(shards, acc))
    if acc is None:
        return torch.zeros((num_groups(col.n), LANES), dtype=torch.int32, device=device)
    return acc[0]


def filter_bitmap_str(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """(ng, LANES) int32 LMP(1) match bitmap for a string predicate on
    ``device``, composable with the query.py bitmap algebra. Ordered ops and
    startswith hit at most one code range; eq/ne at most two; contains may
    fragment into several, each a code scan."""
    if col.scheme != "strdict":
        raise ValueError(f"filter_bitmap_str needs a 'strdict' column, got {col.scheme!r}")
    return _ranges_bitmap(col, _mask_ranges(_dict_mask(col, op, value)), device)


def count_where_str(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda") -> int:
    from .query import count_bits

    return count_bits(filter_bitmap_str(col, op, value, device=device), col.n)


def select_where_str(col: EncodedColumn, op: str, value, *, device: torch.device | str = "cuda") -> np.ndarray:
    """Matching strings (object array), decoding only the groups that hold
    matches (partial.take on the code column)."""
    from .partial import take
    from .ref.lmp import lmp_unpack

    words = filter_bitmap_str(col, op, value, device=device).cpu().numpy().view(np.uint32)
    idx = np.flatnonzero(lmp_unpack(words.reshape(num_groups(col.n), LANES), 1, col.n).astype(bool))
    codes = take(codes_column(col), idx, device=device)
    return dictionary(col)[codes.astype(np.int64)]


def _str_words(col: EncodedColumn, op: str, value, mesh, axis):
    from .dist_query import _mesh

    if col.scheme != "strdict":
        raise ValueError(f"filter_bitmap_str_sharded needs a 'strdict' column, got {col.scheme!r}")
    mesh = _mesh(mesh, axis)
    return mesh, _ranges_bitmap(col, _mask_ranges(_dict_mask(col, op, value)), sharded=True, mesh=mesh, axis=axis)


def filter_bitmap_str_sharded(col: EncodedColumn, op: str, value, mesh=None, axis="d") -> torch.Tensor:
    """Sharded twin of filter_bitmap_str: the same code-range rewrite over
    dist_query's shard-by-shard filter scans; the whole bitmap on the
    mesh's first device."""
    from .dist_query import gather_words

    mesh, parts = _str_words(col, op, value, mesh, axis)
    return gather_words(col.n, mesh, parts)


def count_where_str_sharded(col: EncodedColumn, op: str, value, mesh=None, axis="d") -> int:
    """Sharded string predicate count: one all-reduced scalar."""
    from .dist_query import count_words

    return count_words(*_str_words(col, op, value, mesh, axis))


def isin_bitmap_str(col: EncodedColumn, values, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """Bitmap of membership in a set of strings: the set evaluates over the
    dictionary on the host, then code-range scans (few ranges) or one
    lookup pass over the decoded codes (fragmented sets)."""
    want = {v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in values}
    mask = np.fromiter((e in want for e in _entries(col)), bool, count=col.params["dict_size"])
    return dict_mask_bitmap(col, mask, device=device)


def dict_mask_bitmap(col: EncodedColumn, mask: np.ndarray, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """Bitmap of rows whose dictionary entry is set in ``mask`` (bool[d])."""
    from .query import dict_mask_bitmap as dmb

    return dmb(col, mask, device=device)


# --- aggregates (dictionary answers, no decode) -------------------------------


def min_str(col: EncodedColumn):
    """Bytes-order minimum, dictionary[0]: the dictionary is dense and
    sorted, so the column extreme is the dictionary extreme."""
    return _extreme(col, 0)


def max_str(col: EncodedColumn):
    return _extreme(col, -1)


def _extreme(col: EncodedColumn, pos: int):
    from . import nulls

    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        raise ValueError("min/max of an all-null column")
    return dictionary(col)[pos]


def distinct_count_str(col: EncodedColumn) -> int:
    from . import nulls

    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        return 0
    return col.params["dict_size"]


# The registry entry gives container round trips and the NumPy oracle; the
# device decodes only the code column (api.decode special-cases strdict).
registry.register("strdict", encode_strings, decode_ref)
