"""Multi-GPU decode: the device mesh, the sharded decode, and the host
restructure ``dist_form`` behind it and behind partial decode.

Counterpart of giddy_tpu/dist.py. The GROUP tile is the unit of
distribution (FORMAT.md §3): a column is rewritten so that every stream is
either per-group (leading dim = groups, sliceable on it) or replicated
(dictionaries, bitmap values, exceptions). A mesh of ``nd`` positions
shards the groups: ``ng_pad = cdiv(ng, nd) * nd``, and position ``s`` holds
groups ``[s * ng_pad / nd, (s + 1) * ng_pad / nd)``. Each shard is a
partial.GroupSlicer slice, an ordinary column that the single-GPU decoder
decodes on the shard's device with the same CUDA kernel a single card runs;
replicated streams go up once a device, and steady-state decode needs no
communication at all.

Multi-process meshes: the caller runs ``torch.distributed.init_process_group``
(the reference's ``jax.distributed.initialize()``), and the mesh then lists
ranks x local devices, rank-major. Each process decodes its own positions'
shards; the only collective of the layer is the all-reduce of scalar
counts, sums and extremes (and of a GROUP BY's O(dict_size) partials) in
dist_query.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


# --- the device mesh --------------------------------------------------------


def process_rank() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) unless the caller
    initialized torch.distributed."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


class Mesh:
    """An array of ``torch.device``s with axis names, the counterpart of
    jax.sharding.Mesh; position ``i`` of the flattened array holds shard
    ``i``.

    A device may appear more than once, which a JAX mesh does not allow:
    ``Mesh([torch.device("cuda", 0)] * 4)`` runs four shards of the real
    kernels on one card. Over several processes the array lists ranks x
    local devices, rank-major: position ``i`` belongs to process
    ``i // (size // world size)``, and its device names that process's
    local device."""

    def __init__(self, devices, axis_names=("d",)):
        src = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if src.ndim != len(self.axis_names):
            raise ValueError(f"{src.ndim}-d devices need {src.ndim} axis names, got {self.axis_names}")
        self.devices = np.empty(src.shape, dtype=object)
        for i, d in enumerate(src.flat):
            self.devices.flat[i] = torch.device(d)
        world = process_rank()[1]
        if self.devices.size % world:
            raise ValueError(f"{self.devices.size} mesh positions do not split over {world} processes")
        self.ranks = (np.arange(self.devices.size) // (self.devices.size // world)).reshape(self.devices.shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def key(self) -> tuple:
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat),
                tuple(self.ranks.flat))

    def multi_process(self) -> bool:
        """Whether positions of this mesh belong to other processes."""
        return bool((self.ranks != process_rank()[0]).any())

    def first_device(self) -> torch.device:
        """This process's first device of the mesh: where whole results
        (decodes, bitmaps) are assembled."""
        mine = self.devices[self.ranks == process_rank()[0]]
        if not mine.size:
            raise ValueError("this process holds no position of the mesh")
        return mine.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _visible_devices() -> list[torch.device]:
    """Every local CUDA device, once for each process of the job; a mesh
    with a CUDA device and no card raises rather than moving to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device: pass devices, e.g. [torch.device('cpu')] * 4, for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())] * process_rank()[1]


def default_mesh(axis: str = "d", devices=None) -> Mesh:
    """A 1-D mesh over ``devices``, by default every visible CUDA device
    (of every process, when torch.distributed is initialized)."""
    return Mesh(list(devices) if devices is not None else _visible_devices(), (axis,))


def host_chip_mesh(n_hosts: int, chips_per_host: int, devices=None) -> tuple[Mesh, tuple]:
    """2-D (hosts, chips) mesh and the axis tuple that shards groups over
    both: pass ``axis=("h", "c")`` to the sharded decoders. With
    torch.distributed initialized over ``n_hosts`` processes, row ``h`` is
    process ``h``'s."""
    devices = list(devices) if devices is not None else _visible_devices()
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return Mesh(grid.reshape(n_hosts, chips_per_host), ("h", "c")), ("h", "c")


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def _positions(mesh: Mesh, axis) -> list[tuple[int, torch.device]]:
    """(rank, device) of each shard, in shard order: the mesh's positions
    flattened over the sharding axes (every other axis must be of size 1:
    replicas are not taken)."""
    axes = _axes(axis)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not one of the mesh's {mesh.axis_names}")
    rest = [a for a in mesh.axis_names if a not in axes]
    if any(mesh.shape[a] > 1 for a in rest):
        raise NotImplementedError(f"sharding over {axes} leaves axes {rest} of the mesh as replicas")
    order = [mesh.axis_names.index(a) for a in axes + tuple(rest)]
    devs = np.transpose(mesh.devices, order).reshape(-1)
    ranks = np.transpose(mesh.ranks, order).reshape(-1)
    return [(int(r), d) for r, d in zip(ranks, devs)]


# --- the sharded decode -----------------------------------------------------


@dataclasses.dataclass
class Shard:
    """One mesh position's share of a column: groups [g0, g1) of the real
    groups (g0 == g1 for a shard of pad groups only, which decodes to
    nothing), on ``device`` of process ``rank``. ``col`` is a self-contained
    column decoding exactly those groups and ``streams`` its device-form
    streams on ``device``, once placed (this process's shards only)."""

    index: int
    rank: int
    device: torch.device
    g0: int
    g1: int
    col: EncodedColumn | None = None
    streams: dict | None = None


def _shard_ranges(n: int, nd: int) -> list[tuple[int, int]]:
    """[g0, g1) of each of nd shards (FORMAT.md §3), cut to the real groups."""
    real = num_groups(n) if n else 0
    ng_l = cdiv(num_groups(n), nd)
    return [(min(s * ng_l, real), min((s + 1) * ng_l, real)) for s in range(nd)]


def _host_plan(col: EncodedColumn, mesh: Mesh, axis):
    """(slicer, this process's shards with their host slices), memoized on
    the column for each mesh (giddy_tpu/dist.py:275, a few meshes at a
    time): the signature carries the identity of every stream array, so
    replacing a stream recomputes."""
    from .partial import GroupSlicer

    sig = tuple(sorted((k, id(v)) for k, v in col.streams.items()))
    plans = col.__dict__.setdefault("_dist_plans", {})
    where = (mesh.key(), _axes(axis))
    hit = plans.get(where)
    if hit is not None and hit[0] == sig:
        return hit[1]
    pos = _positions(mesh, axis)
    rank = process_rank()[0]
    slicer = GroupSlicer(col, device="cpu", patches=False)
    shards = []
    for s, ((r, dev), (g0, g1)) in enumerate(zip(pos, _shard_ranges(col.n, len(pos)))):
        if r == rank:
            shards.append(Shard(s, r, dev, g0, g1, slicer.slice(g0, g1) if g1 > g0 else None))
    if len(plans) >= 4:
        plans.pop(next(iter(plans)))
    plans[where] = (sig, (slicer, shards))
    return slicer, shards


def place(col: EncodedColumn, mesh: Mesh, axis="d") -> list[Shard]:
    """This process's shards of ``col`` with their streams on their devices.

    Per-group streams go up shard by shard; a stream that several shards
    share (a dictionary, bitmap values, the exceptions) goes up once a
    device. A patched or alp column's exception positions decode once a
    device (K3 for the compressed kind), and each shard takes its own
    range of them, so that its decoder (K9, K12) writes them in its own
    launch."""
    from .api import device_streams, get_decoder, upload

    if col.scheme in ("wide", "strdict"):
        raise NotImplementedError(f"sharded decode of {col.scheme!r} goes through its 32-bit parts")
    slicer, plan = _host_plan(col, mesh, axis)
    memo: dict[tuple, torch.Tensor] = {}

    def up(streams: dict, device: torch.device) -> dict:
        out = {}
        for k, v in streams.items():
            key = (id(v), str(device))
            if key not in memo:
                memo[key] = upload({k: v}, device)[k]
            out[k] = memo[key]
        return out

    placed = [dataclasses.replace(sh, streams=slicer._streams(sh.col, up, sh.device)) if sh.col is not None else sh
              for sh in plan]
    df = getattr(slicer, "df", None)  # dzbv's slicer has none
    if df is None or not df.patch_params or not df.patch_params["count"]:
        return placed
    pp, ps = df.patch_params, df.patch_streams
    for device in dict.fromkeys(sh.device for sh in placed if sh.col is not None):
        val = up({"patch_val": ps["patch_val"]}, device)["patch_val"]
        if pp["kind"] == "naive":
            pos = up({"patch_pos": ps["patch_pos"]}, device)["patch_pos"]
        else:
            pcol = EncodedColumn(name="_ppos", scheme="delta", dtype="int32", n=pp["count"],
                                 params={"bits": pp["ppos_bits"]},
                                 streams={"packed": ps["ppos_packed"], "anchors": ps["ppos_anchors"]})
            pos = get_decoder(pcol)(device_streams(pcol, device))[: pp["count"]]
        mine = [i for i, sh in enumerate(placed) if sh.device == device and sh.col is not None]
        edges = torch.tensor([g * GROUP for i in mine for g in (placed[i].g0, placed[i].g1)], dtype=torch.int64,
                             device=device)
        cuts = torch.searchsorted(pos.to(torch.int64), edges).tolist()
        for j, i in enumerate(mine):
            a, b = cuts[2 * j], cuts[2 * j + 1]
            sh = placed[i]
            spos = (pos[a:b] - sh.g0 * GROUP).to(torch.int32)
            placed[i] = _patched_shard(col, sh, spos, val[a:b].contiguous())
    return placed


def _patched_shard(col: EncodedColumn, sh: Shard, pos: torch.Tensor, val: torch.Tensor) -> Shard:
    """A shard of a patched or alp column with its own exceptions: alp
    takes them as its own streams; a patched column's shard becomes a
    patched column over its base slice."""
    base, streams = sh.col, dict(sh.streams)
    count = int(pos.shape[0])
    if col.scheme == "alp":
        streams.update(patch_pos=pos, patch_val=val)
        return dataclasses.replace(sh, col=dataclasses.replace(base, params={**base.params, "count": count}),
                                   streams=streams)
    params = {"base_scheme": base.scheme, "base_params": base.params, "kind": "naive", "count": count}
    host = {}
    if "valid" in base.streams:
        params["nullable"] = True
        host["valid"] = base.streams["valid"]
    dev = {f"base_{k}": v for k, v in streams.items() if k != "valid"}
    dev.update(patch_pos=pos, patch_val=val, **({"valid": streams["valid"]} if "valid" in streams else {}))
    sub = EncodedColumn(name=base.name, scheme="patched", dtype=base.dtype, n=base.n, params=params, streams=host)
    return dataclasses.replace(sh, col=sub, streams=dev)


def decode_shard(sh: Shard) -> torch.Tensor:
    """One placed shard's (g1 - g0) * GROUP uint32 payloads (as int32) on
    its device, through the single-GPU decoder of its slice (the kernel of
    its scheme); a shard of pad groups only gives an empty tensor."""
    from .api import get_decoder

    if sh.col is None:
        return torch.empty(0, dtype=torch.int32, device=sh.device)
    return get_decoder(sh.col)(sh.streams)


def run_shards(*shards: Shard) -> list[tuple[int, torch.Tensor]]:
    """The sharded decoder: (g0, payloads) of each shard given, each on
    its own device (the counterpart of a sharded array's
    ``addressable_shards``)."""
    return [(sh.g0, decode_shard(sh)) for sh in shards]


def build_sharded_decoder(col: EncodedColumn, mesh: Mesh, axis="d"):
    """``(fn, args)``: ``fn(*args)`` decodes this process's shards of
    ``col`` on the mesh and returns ``(g0, payloads)`` for each, the uint32
    payloads (as int32) of groups [g0, g1) on the shard's device. The host
    restructure is memoized on the column and the per-slice decoders in
    api.get_decoder's cache; the streams are placed anew on every call
    (dist_query caches placements)."""
    return run_shards, place(col, mesh, axis)


def _assemble(col: EncodedColumn, mesh: Mesh, outs: list) -> torch.Tensor:
    """The logical-dtype tensor of length n on the mesh's first device,
    from every shard's payloads."""
    from .api import _LOGICAL, _to_logical

    if mesh.multi_process():
        raise ValueError(
            "the mesh spans several processes: a whole decode would need a gather; read each process's "
            "shards from dist.build_sharded_decoder (fn(*args) gives (g0, payloads) a shard)"
        )
    first = mesh.first_device()
    parts = [_to_logical(u, col.dtype).to(first) for _, u in outs if u.numel()]
    if not parts:
        return torch.empty(0, dtype=_LOGICAL[col.dtype][1], device=first)
    return torch.cat(parts)[: col.n]


def decode_sharded(col: EncodedColumn, mesh: Mesh | None = None, axis="d"):
    """Sharded decode: the logical-dtype tensor of length n on the mesh's
    first device, as api.decode gives it (NumPy for 64-bit ``wide``
    columns, whose planes decode sharded and recombine on the host). On a
    mesh that spans processes it raises ValueError: read the shards from
    build_sharded_decoder instead."""
    mesh = mesh or default_mesh(axis)
    if col.scheme == "wide":
        from . import wide

        lo = decode_sharded(wide._sub(col, "lo"), mesh, axis).cpu().numpy()
        hi = decode_sharded(wide._sub(col, "hi"), mesh, axis).cpu().numpy()
        return wide._combine(lo.view(np.uint32), hi.view(np.uint32), col.dtype)
    fn, args = build_sharded_decoder(col, mesh, axis)
    return _assemble(col, mesh, fn(*args))


def decode_columns_sharded(cols: list[EncodedColumn], mesh: Mesh | None = None, axis="d") -> dict:
    """Sharded decode of a container's columns (BASELINE configs[4]): every
    column's shards are placed first, then every shard decodes, back to
    back, with no host synchronisation between columns. Results are keyed
    by column name, on the mesh's first device."""
    mesh = mesh or default_mesh(axis)
    built = [build_sharded_decoder(c, mesh, axis) for c in cols]
    outs = [fn(*args) for fn, args in built]
    return {c.name: _assemble(c, mesh, o) for c, o in zip(cols, outs)}


# --- the all-reduce of the sharded scans ----------------------------------


def all_reduce(values: list[int], mesh: Mesh, op: str = "sum") -> list[int]:
    """Exact int64 all-reduce (``op``: sum, min or max) of a few values
    over the processes of a multi-process mesh; the values as they are on
    a mesh of this process alone. The tensor goes to the device the
    backend takes: CUDA for nccl, the CPU for gloo."""
    if not mesh.multi_process():
        return list(values)
    import torch.distributed as tdist

    device = torch.device("cuda", torch.cuda.current_device()) if tdist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor(values, dtype=torch.int64, device=device)
    tdist.all_reduce(t, op={"sum": tdist.ReduceOp.SUM, "min": tdist.ReduceOp.MIN, "max": tdist.ReduceOp.MAX}[op])
    return t.tolist()
