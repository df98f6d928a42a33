"""Partial / random-access decode: any group range, independently.

Counterpart of giddy_tpu/partial.py. Every GROUP tile decodes on its own,
so ``decode_groups(col, g0, g1)`` decodes rows [g0*GROUP, g1*GROUP) only,
touching only those groups' bytes, and ``take(col, idx)`` decodes only the
groups that hold the wanted rows. Slices come from the per-group stream
rewrite of dist.dist_form; dzbv repartitions its compacted planes per
range, and patched columns decode their exception positions once.

``GroupSlicer.decode`` runs the port's cached decoders on the card (the
kernel of the slice's scheme) and returns NumPy, as the reference does:
``take`` is a host gather. Runs of needed groups are rounded up to powers
of two, so scattered lookups reuse a few decoder shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from .dist import dist_form
from .format import EncodedColumn
from .util import GROUP, np_dtype, num_groups


def _device_streams(streams: dict[str, np.ndarray], device: torch.device, upload=None) -> dict[str, torch.Tensor]:
    """A slice's streams on ``device`` (through ``upload``, api.upload by
    default): the dist form's (ng, 1) per-group side streams (anchors,
    refs, slopes, coefficients) become the (ng,) vectors the kernel
    wrappers take."""
    if upload is None:
        from .api import upload

    return {k: t.reshape(-1) if t.dim() == 2 and t.shape[1] == 1 else t for k, t in upload(streams, device).items()}


class GroupSlicer:
    """Per-column cache of the dist-form rewrite; slices group ranges and
    decodes them on ``device``."""

    def __init__(self, col: EncodedColumn, *, device: torch.device | str = "cuda", patches: bool = True):
        """``patches=False`` leaves a patched or alp column's exceptions out
        of the slices (``self.df.patch_streams`` holds them): the sharded
        decode (dist.py) writes them on the card itself."""
        from .api import _decode_device

        if col.scheme == "wide":
            raise NotImplementedError(
                "GroupSlicer works on 32-bit planes; slice a wide column via "
                "partial.decode_groups / partial.take, which split it"
            )
        self.device = _decode_device(device)
        self.col = col
        self.ng = num_groups(col.n)
        if col.scheme == "dzbv":
            # dzbv planes are compacted over the whole column (plane k holds
            # bytes only of elements wider than k), so ranges repartition:
            # unpack the planes once, keep per-group prefix counts, and
            # repack each requested segment
            self._init_dzbv()
            return
        self.df = dist_form(col, 1)
        self._pos = self._val = None
        if patches and self.df.patch_params and self.df.patch_params["count"]:
            self._pos, self._val = self._decode_patches_once()

    def _init_dzbv(self) -> None:
        from .kernels.dzbv import TILE, global_tile_s, global_w4
        from .ref.lmp import lmp_unpack

        col = self.col
        plane_lens = col.params["plane_lens"]
        w = lmp_unpack(col.streams["widths"], 2, col.n).astype(np.int32) + 1
        wp = np.zeros(self.ng * GROUP, np.int32)
        wp[: col.n] = w  # pad elements have width 0: members of no plane
        self._dz_planes = {k: lmp_unpack(col.streams[f"plane{k}"], 8, plane_lens[k]) for k in range(4) if plane_lens[k]}
        # cum[k][g] = elements wider than k in groups [0, g)
        self._dz_cum = {
            k: np.concatenate([[0], np.cumsum((wp.reshape(self.ng, GROUP) > k).sum(1))])
            for k in (1, 2, 3)
            if plane_lens[k]
        }
        # whole-column layout parameters, so that every equal-size slice
        # shares one decoder shape: tile strides first, group-row widths as
        # the fallback
        self._dz_tile_s = global_tile_s(
            {k: (wp.reshape(-1, TILE) > k).sum(axis=1) for k in (1, 2, 3) if plane_lens[k]},
            ragged=col.n < self.ng * GROUP,
        )
        self._dz_w4 = None if self._dz_tile_s is not None else global_w4({k: np.diff(c) for k, c in self._dz_cum.items()})
        self._pos = self._val = None

    def _slice_dzbv(self, g0: int, g1: int) -> EncodedColumn:
        from .ref.lmp import lmp_pack

        col = self.col
        lo, hi = g0 * GROUP, min(g1 * GROUP, col.n)
        streams = {"widths": col.streams["widths"][g0:g1]}
        plane_lens = [hi - lo]  # plane0 holds byte 0 of every element
        streams["plane0"] = lmp_pack(self._dz_planes[0][lo:hi], 8)
        for k in (1, 2, 3):
            if k not in self._dz_planes:
                plane_lens.append(0)
                streams[f"plane{k}"] = lmp_pack(np.empty(0, np.uint32), 8)
                continue
            s, e = int(self._dz_cum[k][g0]), int(self._dz_cum[k][g1])
            seg = self._dz_planes[k][s:e]
            # a power-of-two group count, so that equal-size slices share
            # decoder shapes (the lengths are data-dependent)
            m = len(seg)
            mq = GROUP << max(0, (num_groups(m) - 1).bit_length()) if m else GROUP
            streams[f"plane{k}"] = lmp_pack(np.concatenate([seg, np.zeros(mq - m, np.uint32)]), 8)
            plane_lens.append(mq)
        sub = EncodedColumn(
            name=f"{col.name}[{g0}:{g1}]", scheme="dzbv", dtype=col.dtype, n=hi - lo,
            params={"plane_lens": plane_lens}, streams=streams,
        )
        # the re-layout happens here (decode bypasses the prep), strides and
        # row widths pinned from the whole column
        if self._dz_tile_s is not None:
            from .kernels.dzbv import tile_prep

            sub.streams = tile_prep(sub, force_s=self._dz_tile_s)
        elif self._dz_w4 is not None:
            from .kernels.dzbv import group_prep

            sub.streams = group_prep(sub, force_w4=self._dz_w4)
        return sub

    def _decode_patches_once(self):
        ps, pp = self.df.patch_streams, self.df.patch_params
        if pp["kind"] == "naive":
            pos = ps["patch_pos"].astype(np.int64)
        else:
            from .ref import delta as ref_delta

            pcol = EncodedColumn(
                name="_ppos", scheme="delta", dtype="int32", n=pp["count"],
                params={"bits": pp["ppos_bits"]},
                streams={"packed": ps["ppos_packed"], "anchors": ps["ppos_anchors"]},
            )
            pos = ref_delta.decode(pcol).astype(np.int64)
        return pos, ps["patch_val"]

    def slice(self, g0: int, g1: int) -> EncodedColumn:
        """A self-contained column decoding exactly groups [g0, g1).
        Nullable columns' slices carry their window of the validity words."""
        sub = self._slice_inner(g0, g1)
        if self.col.params.get("nullable") and "valid" in self.col.streams:
            # LMP(1) words are per group, so the window is a row slice
            sub.streams["valid"] = self.col.streams["valid"][g0:g1]
            sub.params = {**sub.params, "nullable": True}
        return sub

    def _slice_inner(self, g0: int, g1: int) -> EncodedColumn:
        if not (0 <= g0 < g1 <= self.ng):
            raise ValueError(f"group range [{g0},{g1}) out of [0,{self.ng})")
        if self.col.scheme == "dzbv":
            return self._slice_dzbv(g0, g1)
        df, col = self.df, self.col
        streams: dict[str, np.ndarray] = {}
        for k, v in df.sharded.items():
            streams[k] = v[:, g0:g1] if df.bitmap_axis1 and k == "bitmaps" else v[g0:g1]
        for pk in ("pos", "c_pos"):  # rle/rpe scatter positions are group-local
            if pk in streams:
                streams[pk] = streams[pk] - np.int32(g0 * GROUP)
        streams.update(df.replicated)
        sub = EncodedColumn(
            name=f"{col.name}[{g0}:{g1}]",
            scheme=df.local_col.scheme,
            dtype=col.dtype,
            n=(g1 - g0) * GROUP if g1 < self.ng else col.n - g0 * GROUP,
            params=df.local_col.params,
            streams=streams,
        )
        if self._pos is not None:
            lo, hi = g0 * GROUP, g1 * GROUP
            m = (self._pos >= lo) & (self._pos < hi)
            sub.scheme = "_patched_slice"
            sub.params = {
                "base_scheme": df.local_col.scheme,
                "base_params": df.local_col.params,
                "kind": "naive",
                "count": int(m.sum()),
            }
            sub.streams = {f"base_{k}": v for k, v in sub.streams.items()}
            sub.streams["patch_pos"] = (self._pos[m] - lo).astype(np.int32)
            sub.streams["patch_val"] = self._val[m]
        return sub

    def decode(self, g0: int, g1: int) -> np.ndarray:
        """Decode groups [g0, g1) on the slicer's device -> the logical
        values of rows [g0*GROUP, min(g1*GROUP, n)), as NumPy. Equal-width
        ranges share one cached decoder."""
        from .api import _to_logical, get_decoder

        sub = self.slice(g0, g1)
        if sub.scheme == "_patched_slice":
            base = EncodedColumn(
                name=f"{self.col.name}.base[{g0}:{g1}]",
                scheme=sub.params["base_scheme"], dtype=sub.dtype, n=sub.n,
                params=sub.params["base_params"],
                streams={k[len("base_"):]: v for k, v in sub.streams.items() if k.startswith("base_")},
            )
            u = get_decoder(base)(self._streams(base))
            if sub.params["count"]:
                pos = torch.from_numpy(sub.streams["patch_pos"].astype(np.int64)).to(self.device)
                val = torch.from_numpy(np.ascontiguousarray(sub.streams["patch_val"]).view(np.int32)).to(self.device)
                u = u.index_put_((pos,), val)
            return _to_logical(u, self.col.dtype)[: sub.n].cpu().numpy()
        u = get_decoder(sub)(self._streams(sub))
        return _to_logical(u, self.col.dtype)[: sub.n].cpu().numpy()

    def _streams(self, sub: EncodedColumn, upload=None, device: torch.device | None = None) -> dict[str, torch.Tensor]:
        """A slice's streams on ``device`` (the slicer's by default), ready
        for its decoder (slices skip the registry's prep: they are in
        device form)."""
        device = self.device if device is None else device
        streams = _device_streams(sub.streams, device, upload)
        if sub.scheme == "alp":  # the slice's exceptions are written after the decode
            streams.setdefault("patch_pos", torch.zeros(0, dtype=torch.int32, device=device))
            streams.setdefault("patch_val", torch.zeros(0, dtype=torch.int32, device=device))
        return streams


def slice_groups(col: EncodedColumn, g0: int, g1: int) -> EncodedColumn:
    return GroupSlicer(col, device="cpu").slice(g0, g1)


def decode_groups(col: EncodedColumn, g0: int, g1: int, *, device: torch.device | str = "cuda") -> np.ndarray:
    if col.scheme == "wide":  # plane-wise random access, recombined on the host
        from . import wide

        lo = GroupSlicer(wide._sub(col, "lo"), device=device).decode(g0, g1)
        hi = GroupSlicer(wide._sub(col, "hi"), device=device).decode(g0, g1)
        return wide._combine(lo.view(np.uint32), hi.view(np.uint32), col.dtype)
    return GroupSlicer(col, device=device).decode(g0, g1)


def take(col: EncodedColumn, indices, *, device: torch.device | str = "cuda") -> np.ndarray:
    """Point lookups ``col[indices]``, decoding on ``device`` only the
    groups that hold them. Indices may repeat and come in any order.
    Contiguous needed groups decode in one call; run lengths round up to
    powers of two so scattered lookups reuse a few decoder shapes."""
    idx = np.asarray(indices, dtype=np.int64)
    out_shape = idx.shape
    idx = idx.reshape(-1)
    if idx.size == 0:
        return np.empty(out_shape, np_dtype(col.dtype))
    if ((idx < 0) | (idx >= col.n)).any():
        bad = idx[(idx < 0) | (idx >= col.n)][0]
        raise IndexError(f"index {bad} out of range for column of n={col.n}")
    if col.scheme == "wide":
        from . import wide

        lo = take(wide._sub(col, "lo"), idx, device=device)
        hi = take(wide._sub(col, "hi"), idx, device=device)
        return wide._combine(lo.view(np.uint32), hi.view(np.uint32), col.dtype).reshape(out_shape)
    slicer = GroupSlicer(col, device=device)
    groups = np.unique(idx // GROUP)
    # maximal contiguous runs of needed groups
    starts = np.flatnonzero(np.diff(groups, prepend=groups[0] - 2) > 1)
    out = np.empty(idx.shape, np_dtype(col.dtype))
    for s, e in zip(starts, np.append(starts[1:], groups.size)):
        g0, g_last = int(groups[s]), int(groups[e - 1])
        want = g_last + 1 - g0
        g1 = min(g0 + (1 << (want - 1).bit_length()), slicer.ng)  # pow2 sizing
        vals = slicer.decode(g0, g1)
        m = (idx >= g0 * GROUP) & (idx < (g_last + 1) * GROUP)
        out[m] = vals[idx[m] - g0 * GROUP]
    return out.reshape(out_shape)


def decode_ref_groups(col: EncodedColumn, g0: int, g1: int) -> np.ndarray:
    """Oracle twin of decode_groups (full NumPy decode, then slice)."""
    from . import registry

    full = registry.get(col.scheme).decode_ref(col)
    return full[g0 * GROUP : min(g1 * GROUP, col.n)]
