"""Public decode API of the PyTorch port (counterpart of giddy_tpu/api.py).

``decode(col)``: registry lookup -> host prep -> upload of the
streams -> (cached) decoder -> its kernel -> logical-dtype tensor.
``decode_columns(cols)`` does the same for a container's columns, all
uploads first, then all decoders. Every entry point runs on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``. On a CUDA
device the decoder launches the hand-written kernels of csrc/; on the CPU it
runs their plain PyTorch versions (kernels/lanes.py).

64-bit columns decode through the ``wide`` scheme (wide.py: both 32-bit
planes through their kernels, the int64 recombine on the card); string
columns through ``strdict`` (strings.py: the codes on the card, the string
gather on the host, which returns a NumPy object array).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import kernels as _kernels  # noqa: F401  (installs device decoders)
from . import ref as _ref  # noqa: F401  (installs host codecs)
from . import strings as _strings  # noqa: F401  (installs the string-dictionary scheme)
from . import wide as _wide  # noqa: F401  (installs the 64-bit plane wrapper)
from . import registry, trace, util
from .format import EncodedColumn
from .util import GROUP, check_device_addressable, num_groups

_DECODER_CACHE: dict[tuple, object] = {}

# Logical dtype -> (storage dtype the kernels write, dtype the caller sees).
# Narrow columns store at their own width (the reference's narrow_store);
# uint16 rides in int16 storage, since torch has little uint16 arithmetic.
_LOGICAL = {
    "int32": (torch.int32, torch.int32),
    "uint32": (torch.int32, torch.uint32),
    "float32": (torch.int32, torch.float32),
    "int16": (torch.int16, torch.int16),
    "uint16": (torch.int16, torch.uint16),
    "int8": (torch.uint8, torch.int8),
    "uint8": (torch.uint8, torch.uint8),
}


def encode(values: np.ndarray, scheme: str, *, valid=None, **opts) -> EncodedColumn:
    """Host-side encode with the port's NumPy codecs (byte-identical to
    ``giddy_tpu.encode`` for the ported schemes).

    ``valid``: optional bool[n] mask (True = non-null) making the column
    nullable: null slots take the canonical fill (the previous valid
    value) before encoding, and a ``valid`` LMP(1) stream is attached
    (nulls.py). ``scheme="auto"`` routes through the advisor
    (advisor.encode_best: trial encodes on a sample, best ratio wins)."""
    if scheme == "auto":
        from .advisor import encode_best

        if valid is not None:
            from . import nulls

            mask = np.asarray(valid, bool)
            return nulls.attach_valid(encode_best(nulls.fill_nulls(np.asarray(values), mask), **opts), mask)
        return encode_best(np.asarray(values), **opts)
    if valid is not None:
        from . import nulls

        mask = np.asarray(valid, bool)
        filled = nulls.fill_nulls(np.asarray(values), mask)
        return nulls.attach_valid(registry.get(scheme).encode(filled, **opts), mask)
    return registry.get(scheme).encode(values, **opts)


def decode_ref(col: EncodedColumn) -> np.ndarray:
    """NumPy oracle decode — the bit-exactness reference."""
    return registry.get(col.scheme).decode_ref(col)


def _check_supported(col: EncodedColumn) -> None:
    registry.get(col.scheme)  # raises KeyError for an unknown scheme
    if col.scheme == "wide":
        if col.dtype not in _wide.TORCH_DTYPES:
            raise ValueError(f"a wide column is 64-bit, got dtype {col.dtype!r} of {col.name!r}")
    elif col.scheme != "strdict" and col.dtype not in _LOGICAL:
        raise NotImplementedError(
            f"dtype {col.dtype!r} of {col.name!r} is decoded only through the 64-bit "
            f"'wide' scheme, not through {col.scheme!r}"
        )
    check_device_addressable(col.n, f"device decode of {col.name!r}")


def narrow_store_dtype(col: EncodedColumn) -> torch.dtype:
    """The dtype the decoder stores: the column's own width for int8/int16
    columns of narrow-store schemes, the int32 payload otherwise."""
    store = _LOGICAL[col.dtype][0]
    if store != torch.int32 and not registry.get(col.scheme).narrow_store:
        return torch.int32
    return store


def get_decoder(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    """Build (or fetch cached) the decoder for this column's static
    configuration: fn(streams) -> (n_pad,) tensor of out_store."""
    _check_supported(col)
    key = (col.static_key(), out_store)
    fn = _DECODER_CACHE.get(key)
    if fn is None:
        builder = registry.get(col.scheme).decode_device
        if builder is None:
            raise NotImplementedError(f"no device decoder for {col.scheme!r}")
        with trace.span("build_decoder", col.scheme):
            fn = _DECODER_CACHE[key] = _traced(builder(col, out_store), col.scheme)
    return fn


def _traced(decoder, scheme: str):
    """``decoder`` inside a ``giddy.decode:<scheme>`` span."""
    def decode(streams):
        with trace.span("decode", scheme):
            return decoder(streams)
    return decode


def upload(streams: dict[str, np.ndarray], device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """Each host stream as a tensor on ``device``; uint32 word streams
    travel as int32 carrying the same bits.

    A read-only stream (a container's bytes, ``Table.open``'s mmap) is
    copied first on the CPU, so that no tensor aliases it; to the card the
    host-to-device copy is the only copy, and torch's warning about the
    read-only source is silenced for that call alone."""
    device = torch.device(device)
    out = {}
    for k, v in streams.items():
        v = np.ascontiguousarray(v)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        if device.type == "cpu":
            out[k] = torch.from_numpy(v if v.flags.writeable else v.copy())
        elif v.flags.writeable:
            with trace.span("wait", "upload"):  # from pageable host memory: the copy blocks
                out[k] = torch.from_numpy(v).to(device)
        else:
            with warnings.catch_warnings(), trace.span("wait", "upload"):
                warnings.filterwarnings("ignore", "The given NumPy array is not writable", UserWarning)
                out[k] = torch.from_numpy(v).to(device)
    return out


def device_streams(col: EncodedColumn, device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """Host prep, then :func:`upload` of the prepped streams."""
    with trace.span("device_streams", col.scheme):
        prep = registry.get(col.scheme).prep_streams
        with trace.span("prep", col.scheme):
            streams = prep(col) if prep is not None else col.streams
        return upload(streams, device)


def _to_logical(u: torch.Tensor, dtype: str) -> torch.Tensor:
    store, logical = _LOGICAL[dtype]
    if u.dtype != store:  # a uint32 payload of a narrow column: truncate
        u = u.to(store)
    return u.view(logical)


def _decode_device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode on a CUDA device, but torch sees no CUDA device")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no decoder for device {device}")
    return device


def _decode_chunked(col: EncodedColumn, *, pad: bool, device: torch.device) -> np.ndarray:
    """Decode of a column past the single-call addressing limit
    (giddy_tpu/api.py:105-129): group chunks of half the limit through
    partial.GroupSlicer, each an independent decode on ``device``,
    assembled on the host (a decoded column of 2^31 values or more would
    not fit one device buffer anyway). Wide columns chunk each plane and
    recombine on the host."""
    from .partial import GroupSlicer

    if col.scheme == "wide":
        lo = _decode_chunked(_wide._sub(col, "lo"), pad=pad, device=device)
        hi = _decode_chunked(_wide._sub(col, "hi"), pad=pad, device=device)
        return _wide._combine(lo.view(np.uint32), hi.view(np.uint32), col.dtype)
    ng = num_groups(col.n)
    chunk = max(1, (util.MAX_DEVICE_ELEMS // GROUP) // 2)
    slicer = GroupSlicer(col, device=device)
    out = np.concatenate([slicer.decode(g0, min(g0 + chunk, ng)) for g0 in range(0, ng, chunk)])
    return np.pad(out, (0, ng * GROUP - col.n)) if pad else out


def decode(col: EncodedColumn, *, device: torch.device | str = "cuda", pad: bool = False):
    """Decode a column on ``device`` (the card unless ``"cpu"`` is asked).

    Returns a tensor of the column's logical dtype on that device, of
    length n, or n_pad (whole groups) when ``pad=True``; a wide column's is
    int64, uint64 or float64. A strdict column returns the NumPy object
    array of its strings (``pad`` does not apply). A column whose padded
    length reaches ``util.MAX_DEVICE_ELEMS`` decodes in group chunks on
    ``device`` and returns a NumPy array (the reference's behaviour)."""
    device = _decode_device(device)
    if col.scheme != "strdict" and num_groups(col.n) * GROUP >= util.MAX_DEVICE_ELEMS:
        return _decode_chunked(col, pad=pad, device=device)
    _check_supported(col)
    if col.scheme == "strdict":
        return _strings.decode(col, device=device)
    if col.scheme == "wide":
        return _wide.decode_device(col, device=device, pad=pad)
    if col.n == 0 and not pad:
        return torch.empty(0, dtype=_LOGICAL[col.dtype][1], device=device)
    u = get_decoder(col, narrow_store_dtype(col))(device_streams(col, device))
    out = _to_logical(u, col.dtype)
    return out if pad else out[: col.n]


def _parts(col: EncodedColumn) -> list[EncodedColumn]:
    """The 32-bit columns that decode ``col``: its two planes (wide), its
    code column (strdict), or itself."""
    if col.scheme == "wide":
        return [_wide._sub(col, "lo"), _wide._sub(col, "hi")]
    if col.scheme == "strdict":
        return [_strings.codes_column(col)]
    return [col]


def decode_columns(cols: list[EncodedColumn], *, device: torch.device | str = "cuda", pad: bool = False) -> dict:
    """Decode a whole container's columns on ``device`` (the mixed column
    set of BASELINE configs[4]; counterpart of giddy_tpu/api.py:159-182).

    Every column's streams are uploaded first (a wide column's two planes,
    a strdict column's codes); then every cached decoder runs, back to back
    on the current stream, with no host synchronisation between columns.
    Wide planes recombine on the card; strdict codes gather their strings
    on the host after the last decoder. Results are keyed by column name, a
    later column of the same name replacing an earlier one."""
    device = _decode_device(device)
    for col in cols:
        _check_supported(col)
    parts = [_parts(col) for col in cols]
    flat = [p for ps in parts for p in ps]
    decoders = [get_decoder(p, narrow_store_dtype(p)) for p in flat]
    streams = [device_streams(p, device) for p in flat]
    outs = iter([_to_logical(dec(s), p.dtype) for p, dec, s in zip(flat, decoders, streams)])
    result = {}
    for col, ps in zip(cols, parts):
        got = [next(outs) for _ in ps]
        if col.scheme == "wide":
            out = _wide.combine_device(*got, col.dtype)
        elif col.scheme == "strdict":
            result[col.name] = _strings.dictionary(col)[got[0][: col.n].cpu().numpy()]
            continue
        else:
            out = got[0]
        result[col.name] = out if pad else out[: col.n]
    return result
