"""The host restructure behind partial decode: ``dist_form``.

Counterpart of the NumPy half of giddy_tpu/dist.py (``DistForm`` :47,
``_pad_groups`` :63, ``dist_form`` :71). The GROUP tile is the unit of
distribution (FORMAT.md §3): a column is rewritten so that every stream is
either per-group (leading dim = groups, sliceable on it) or replicated
(dictionaries, bitmap values). partial.GroupSlicer slices that form into
self-contained group ranges. The ``torch.distributed`` decode that shards
the same form over GPUs is ROADMAP.md queue 1, item 8.

The form is rebuilt on every call; partial.GroupSlicer holds it for the
life of one slicer (no cache keyed on ``id()`` here: an id is reused once
its column is collected).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .format import EncodedColumn
from .util import GROUP, LANES, cdiv, num_groups


@dataclasses.dataclass
class DistForm:
    """A column rewritten so every stream is either per-group (leading dim =
    ng, shardable on it) or replicated; plus the local column template whose
    decoder each shard runs."""

    local_col: EncodedColumn  # params/n describe ONE shard's slice
    sharded: dict[str, np.ndarray]  # leading dim = ng_padded
    replicated: dict[str, np.ndarray]
    bitmap_axis1: bool = False  # bitmaps shard on axis 1, not 0
    shard_leading: bool = False  # streams carry an explicit shard dim 0
    ng: int = 0  # unpadded group count
    # patched-only: applied globally after the per-shard decode
    patch_streams: dict[str, np.ndarray] | None = None
    patch_params: dict | None = None


def _pad_groups(a: np.ndarray, ng: int, ng_pad: int, axis: int = 0) -> np.ndarray:
    if ng == ng_pad:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, ng_pad - ng)
    return np.pad(a, pad)


def dist_form(col: EncodedColumn, n_shards: int) -> DistForm:
    """Rewrite ``col`` for ``n_shards`` shards (FORMAT.md §3), stream for
    stream as giddy_tpu.dist.dist_form."""
    ng = num_groups(col.n)
    ng_pad = cdiv(ng, n_shards) * n_shards
    ng_l = ng_pad // n_shards
    scheme, p, st = col.scheme, col.params, col.streams

    def local(params: dict, streams: dict[str, np.ndarray], repl: dict[str, np.ndarray] | None = None, **kw):
        lc = EncodedColumn(
            name=col.name, scheme=kw.pop("scheme", scheme), dtype=col.dtype,
            n=ng_l * GROUP, params=params, streams={},
        )
        axis1 = kw.get("bitmap_axis1", False)
        return DistForm(
            local_col=lc,
            sharded={
                k: _pad_groups(v, ng, ng_pad, axis=1 if (axis1 and k == "bitmaps") else 0)
                for k, v in streams.items()
            },
            replicated=repl or {},
            ng=ng,
            **kw,
        )

    if scheme in ("nbit", "dzbf"):
        return local(dict(p), {"packed": st["packed"]})
    if scheme == "raw":
        return local({}, {"data": st["data"].reshape(ng, GROUP)})
    if scheme in ("delta", "xordelta"):
        return local(dict(p), {"packed": st["packed"], "anchors": st["anchors"].reshape(ng, 1)})
    if scheme == "delta2":
        return local(dict(p), {
            "packed": st["packed"],
            "anchors": st["anchors"].reshape(ng, 1),
            "slopes": st["slopes"].reshape(ng, 1),
        })
    if scheme == "for":
        gpf = p["frame_len"] // GROUP
        refs_g = np.repeat(st["refs"], gpf)[:ng].reshape(ng, 1)
        return local({"bits": p["bits"], "frame_len": GROUP}, {"packed": st["packed"], "refs_g": refs_g})
    if scheme == "model":
        from .kernels import model as k_model

        pre = k_model.prep(col)  # per-group coefficients, (ng,) here and (ng, 1) in the reference
        return local(
            {"bits": p["bits"], "frame_len": GROUP, "kind": p["kind"]},
            {"packed": pre["packed"], **{k: pre[k].reshape(ng, 1) for k in ("a_g", "b_g", "c_g") if k in pre}},
        )
    if scheme == "dict":
        return local(dict(p), {"codes": st["codes"]}, repl={"values": st["values"]})
    if scheme == "cascade":
        # recurse on the nested code column, re-prefix its form and
        # replicate the dictionary (broadcast once, as dict's)
        from .ref.cascade import codes_column

        df = dist_form(codes_column(col), n_shards)
        lc = df.local_col
        df.local_col = EncodedColumn(
            name=col.name, scheme="cascade", dtype=col.dtype, n=lc.n,
            params={"codes_scheme": lc.scheme, "codes_params": lc.params, "dict_size": p["dict_size"]},
            streams={},
        )
        df.sharded = {f"c_{k}": v for k, v in df.sharded.items()}
        df.replicated = {f"c_{k}": v for k, v in df.replicated.items()}
        df.replicated["values"] = st["values"]
        return df
    if scheme in ("rle", "rpe"):
        from .kernels.rle import scatter_prep, tile_prep

        r_pad = p["r_pad"]
        key = "run_ends" if scheme == "rle" else "run_starts"
        bounds = st[key].reshape(ng, r_pad)
        vals = st["run_values"].reshape(ng, r_pad)
        if ng != ng_pad:
            bounds = np.concatenate([bounds, np.full((ng_pad - ng, r_pad), GROUP, np.int32)])
            vals = _pad_groups(vals, ng, ng_pad)
        # the tile form (leading dim ng_pad: slices on groups); runs too
        # dense for it take the scatter pairs
        pre = tile_prep(vals, bounds, positions=(scheme == "rpe"))
        if pre is None:
            pre = scatter_prep(vals, bounds, positions=(scheme == "rpe"), ng_local=ng_l)
        df = local(dict(p), {}, repl={})
        df.sharded = pre
        return df
    if scheme == "bitmap":
        d = p["d"]
        bitmaps = st["bitmaps"].reshape(d, ng, LANES)
        return local(dict(p), {"bitmaps": bitmaps}, repl={"values": st["values"]}, bitmap_axis1=True)
    if scheme == "dzbv":
        # the tile form, then the group-row form: every stream per group
        from .kernels.dzbv import group_prep, tile_prep

        pre = tile_prep(col)
        if pre is None:
            pre = group_prep(col)
        if pre is not None:
            return local(dict(p), pre)
        # group skew past PAD_CAP: each shard's share of every plane is
        # repacked into its own LMP groups, plane lengths equalized with
        # zero padding (the decode's rank gather never reads past a shard's
        # real count)
        from .ref.lmp import lmp_pack, lmp_unpack

        widths = np.zeros(ng_pad * GROUP, np.int32)
        widths[: ng * GROUP] = lmp_unpack(st["widths"], 2, ng * GROUP).astype(np.int32) + 1
        widths[col.n :] = 0  # pad elements select no plane beyond plane0
        w_sh = widths.reshape(n_shards, ng_l * GROUP)
        shard_streams: dict[str, np.ndarray] = {
            "widths": _pad_groups(st["widths"], ng, ng_pad).reshape(n_shards, ng_l, -1)
        }
        plane_lens_local = []
        for k in range(4):
            if k == 0:
                sel = [np.minimum(w, 1).astype(bool) for w in w_sh]
            else:
                sel = [w > k for w in w_sh]
            counts = [int(s.sum()) for s in sel]
            m_max = max(counts) if counts else 0
            plane_lens_local.append(m_max)
            if k > 0 and col.params["plane_lens"][k] == 0:
                plane_lens_local[k] = 0
                continue
            full = lmp_unpack(st[f"plane{k}"], 8, col.params["plane_lens"][k])
            gmask = np.concatenate(sel)
            owner = np.repeat(np.arange(n_shards), ng_l * GROUP)[gmask]
            per_shard = []
            for s in range(n_shards):
                seg = full[: gmask.sum()][owner == s]
                pad = np.zeros(m_max - seg.shape[0], np.uint32)
                per_shard.append(lmp_pack(np.concatenate([seg, pad]), 8))
            shard_streams[f"plane{k}"] = np.stack(per_shard)
        lc = EncodedColumn(
            name=col.name, scheme="dzbv", dtype=col.dtype, n=ng_l * GROUP,
            params={"plane_lens": plane_lens_local}, streams={},
        )
        return DistForm(local_col=lc, sharded=shard_streams, replicated={}, ng=ng, shard_leading=True)
    if scheme == "alp":
        # FOR-shaped main streams per group; the exceptions ride the
        # patched mechanism (replicated, written over the decode after)
        df = local(
            {"bits": p["bits"], "corr_bits": p["corr_bits"], "exp_e": p["exp_e"], "count": 0},
            {"packed": st["packed"], "corr": st["corr"], "refs_g": st["refs"].reshape(ng, 1)},
        )
        if p["count"]:
            df.patch_streams = {"patch_pos": st["patch_pos"], "patch_val": st["patch_val"]}
            df.patch_params = {"kind": "naive", "count": p["count"]}
        return df
    if scheme == "patched":
        base = EncodedColumn(
            name=col.name, scheme=col.params["base_scheme"], dtype=col.dtype, n=col.n,
            params=dict(p["base_params"]),
            streams={k[len("base_"):]: v for k, v in st.items() if k.startswith("base_")},
        )
        df = dist_form(base, n_shards)
        df.patch_streams = {k: v for k, v in st.items() if not k.startswith("base_")}
        df.patch_params = {
            "kind": p["kind"],
            "count": p["count"],
            **{k: v for k, v in p.items() if k.startswith("ppos_")},
        }
        return df
    raise NotImplementedError(f"dist decode for scheme {scheme!r}")
