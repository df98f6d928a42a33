"""Exception patching (naive + compressed positions) — host codec (FORMAT.md §1.11).

The port's copy of giddy_tpu/ref/patch.py. The base scheme (``nbit`` or
``for``) packs the common case at a narrow width; the exceptions are
written over the decoded base afterwards. The ``compressed`` kind stores
the strictly ascending exception positions as a nested delta column.

The streams and params are the code's, not FORMAT.md §1.11's names:
``patch_pos`` or ``ppos_packed``/``ppos_anchors``, ``patch_val``,
``base_packed`` (+ ``base_refs``), and top-level ``base_scheme``,
``base_params``, ``kind``, ``count`` (+ ``ppos_bits``).
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, bits_needed, cdiv, dtype_to_u32, pad_to_groups, u32_to_dtype
from . import delta as ref_delta
from .lmp import lmp_pack, lmp_unpack


def _pick_bits(x: np.ndarray, cover: float) -> int:
    """Smallest B covering ``cover`` fraction of values."""
    if x.size == 0:
        return 1
    q = np.quantile(x.astype(np.float64), cover, method="lower")
    return bits_needed(int(q))


def encode(
    values: np.ndarray,
    *,
    base_scheme: str = "for",
    kind: str = "naive",
    bits: int | None = None,
    cover: float = 0.98,
    frame_len: int = GROUP,
    name: str = "col",
) -> EncodedColumn:
    if base_scheme not in ("nbit", "for"):
        raise ValueError(f"patched base must be nbit|for, got {base_scheme}")
    if kind not in ("naive", "compressed"):
        raise ValueError(f"patch kind must be naive|compressed, got {kind}")
    values = np.asarray(values)
    n = values.shape[0]
    u32 = dtype_to_u32(values)
    fill = int(u32[-1]) if n else 0  # last-value pad keeps frame refs sane
    u = pad_to_groups(u32, fill=fill)
    base_params: dict = {}
    streams: dict = {}
    if base_scheme == "for":
        if frame_len % GROUP:
            raise ValueError(f"frame_len must be a multiple of GROUP={GROUP}")
        nf = cdiv(u.shape[0], frame_len)
        upad = np.full(nf * frame_len, fill, dtype=np.uint32)
        upad[: u.shape[0]] = u
        refs = upad.reshape(nf, frame_len).min(axis=1)
        offs = (upad.reshape(nf, frame_len) - refs[:, None]).reshape(-1)[: u.shape[0]]
        base_params["frame_len"] = frame_len
        streams["base_refs"] = refs.astype(np.int32)
    else:
        offs = u
    if bits is None:
        bits = _pick_bits(offs[:n], cover)
    mask = offs >> np.uint32(bits) != 0 if bits < 32 else np.zeros_like(offs, bool)
    # Pad positions are zeroed like exceptions (they may repeat an
    # exceptional last value) but are never recorded as patches.
    pos = np.nonzero(mask[:n])[0].astype(np.int64)
    patch_val = u[pos].view(np.int32)
    offs = np.where(mask, 0, offs)  # a benign stand-in for each exception
    base_params["bits"] = int(bits)
    streams["base_packed"] = lmp_pack(offs, bits)
    params = {
        "base_scheme": base_scheme,
        "base_params": base_params,
        "kind": kind,
        "count": int(pos.shape[0]),
    }
    if kind == "naive":
        streams["patch_pos"] = pos.astype(np.int32)
    else:
        # nested delta column over the ascending positions (small deltas)
        pcol = ref_delta.encode(pos.astype(np.int32), name="_ppos")
        params["ppos_bits"] = pcol.params["bits"]
        streams["ppos_packed"] = pcol.streams["packed"]
        streams["ppos_anchors"] = pcol.streams["anchors"]
    streams["patch_val"] = patch_val
    return EncodedColumn(
        name=name,
        scheme="patched",
        dtype=str(values.dtype),
        n=n,
        params=params,
        streams=streams,
    )


def _decode_positions(col: EncodedColumn) -> np.ndarray:
    if col.params["kind"] == "naive":
        return col.streams["patch_pos"].astype(np.int64)
    pcol = EncodedColumn(
        name="_ppos",
        scheme="delta",
        dtype="int32",
        n=col.params["count"],
        params={"bits": col.params["ppos_bits"]},
        streams={"packed": col.streams["ppos_packed"], "anchors": col.streams["ppos_anchors"]},
    )
    return ref_delta.decode(pcol).astype(np.int64)


def decode(col: EncodedColumn) -> np.ndarray:
    bp = col.params["base_params"]
    offs = lmp_unpack(col.streams["base_packed"], bp["bits"], col.n)
    if col.params["base_scheme"] == "for":
        refs = col.streams["base_refs"].view(np.uint32)
        fidx = np.arange(col.n, dtype=np.int64) // bp["frame_len"]
        u = (refs[fidx] + offs).astype(np.uint32)
    else:
        u = offs
    u = u.copy()
    u[_decode_positions(col)] = col.streams["patch_val"].view(np.uint32)
    return u32_to_dtype(u, col.dtype)


registry.register("patched", encode, decode)
