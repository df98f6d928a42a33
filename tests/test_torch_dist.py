"""giddy_tpu_torch.dist's sharded decode on the CPU, tolerance 0.

- Against the reference's own sharded decode: giddy_tpu.dist.decode_sharded
  and decode_columns_sharded on a 4-device virtual CPU mesh (the first four
  of the devices that tests/conftest.py's XLA flags make; Pallas in
  interpret mode), run in the worker's reference process
  (test_torch_inputs.JAX), and the port's on ``Mesh([cpu] * 4)``, over
  nbit, dict, rle, patched (compressed positions), dzbv (the group skew
  that declines the group-row form), a nullable FOR column and a wide
  column, at ng % 4 != 0.
- Every other scheme of tests/dist_checks.py's DIST_SCHEMES against the
  port's single-device decode and its oracle, at ng % 4 != 0, ng < 4
  (n = GROUP + 5) and n = 0; the 2-D host x chip mesh; the mesh itself.
- A two-process drill (torch.distributed over gloo, two spawned processes,
  ``host_chip_mesh(2, 2)`` over CPU devices, modelled on
  tests/dist2proc_check.py): each process's shards bit-exact against the
  oracle, count_where_sharded, sum_sharded and a GROUP BY all-reduced
  exactly, and min/max/count/sum of a two-group column, where one process
  holds only pad shards.

This module imports no JAX at its top, so that the drill's processes
start without it."""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import dist
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP, num_groups

from test_torch_inputs import JAX, rng_of

CPU = torch.device("cpu")
MESH = dist.Mesh([CPU] * 4)
N = 5 * GROUP + 421  # six groups over four shards: two pad groups, a ragged tail


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- the reference's sharded decode ---------------------------------------------

REF_CASES = ["nbit", "dict", "rle", "patched-compressed", "dzbv-skew", "for-nullable", "wide"]


def ref_values(label: str):
    """(values, valid or None, scheme, encode options) of a case."""
    rng = rng_of(f"dist/{label}")
    if label == "patched-compressed":
        return gen_column("patched", N, rng), None, "patched", {"kind": "compressed"}
    if label == "dzbv-skew":  # sorted: wide bytes gather in the late groups
        return np.sort(gen_column("dzbv", N, rng).view(np.uint32)).view(np.int32), None, "dzbv", {}
    if label == "for-nullable":
        return gen_column("for", N, rng), rng.random(N) > 0.1, "for", {}
    if label == "wide":
        return rng.integers(-(2**62), 2**62, N, dtype=np.int64), None, "wide", {}
    return gen_column(label, N, rng), None, label, {}


def ref_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:4]), ("d",))


def ref_decodes() -> dict:
    """The reference's decode_sharded of every case, and its
    decode_columns_sharded of the 32-bit ones, on a 4-device mesh."""
    import giddy_tpu as gt
    from giddy_tpu import dist as jdist

    mesh = ref_mesh()
    cols = {}
    out = {}
    for label in REF_CASES:
        v, valid, scheme, opts = ref_values(label)
        cols[label] = gt.encode(v, scheme, name=label, valid=valid, **opts)
        out[label] = np.asarray(jdist.decode_sharded(cols[label], mesh))
    together = jdist.decode_columns_sharded([cols[c] for c in REF_CASES if c != "wide"], mesh)
    out["columns"] = {k: np.asarray(a) for k, a in together.items()}
    return out


_REF = {}


def reference() -> dict:
    if not _REF:
        _REF.update(JAX(ref_decodes))
    return _REF


def port_column(label: str):
    v, valid, scheme, opts = ref_values(label)
    return gtt.encode(v, scheme, name=label, valid=valid, **opts)


def same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("label", REF_CASES)
def test_decode_sharded_matches_the_reference(label):
    col = port_column(label)
    if label == "dzbv-skew":
        from giddy_tpu_torch.kernels.dzbv import group_prep

        assert group_prep(col) is None, "the skewed column fits the group-row form"
    got = dist.decode_sharded(col, MESH)
    got = got if isinstance(got, np.ndarray) else got.numpy()
    assert same(got, reference()[label])
    assert same(got, gtt.decode_ref(col))


def test_decode_columns_sharded_matches_the_reference():
    cols = [port_column(c) for c in REF_CASES if c != "wide"]
    got = dist.decode_columns_sharded(cols, MESH)
    want = reference()["columns"]
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        assert same(a.numpy(), want[name]), name


# --- every other scheme against the port's single-device decode -------------------

OTHER = ["for", "delta", "delta2", "rpe", "model", "bitmap", "dzbf", "raw", "xordelta", "alp", "cascade"]
SIZES = {"ragged": N, "fewer-groups-than-shards": GROUP + 5, "empty": 0}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("scheme", OTHER)
def test_decode_sharded_matches_single_device(scheme, size):
    n = SIZES[size]
    col = gtt.encode(gen_column(scheme, n, rng_of(f"dist/other/{scheme}/{n}")), scheme)
    got = dist.decode_sharded(col, MESH)
    want = gtt.decode(col, device=CPU)
    assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert same(got.numpy(), gtt.decode_ref(col))


@pytest.mark.parametrize("scheme", ["nbit", "rle", "alp", "patched"])
def test_shards_hold_their_groups(scheme):
    """fn(*args) gives each shard's payloads at its group offset on its
    device; shards of pad groups only decode to nothing."""
    n = GROUP + 5  # two real groups over four shards
    col = gtt.encode(gen_column(scheme, n, rng_of(f"dist/shards/{scheme}")), scheme)
    fn, args = dist.build_sharded_decoder(col, MESH)
    outs = fn(*args)
    assert [g0 for g0, _ in outs] == [0, 1, 2, 2]
    assert [u.numel() for _, u in outs] == [GROUP, GROUP, 0, 0]
    ref = gtt.decode_ref(col)
    got = np.concatenate([u.numpy() for _, u in outs]).view(ref.dtype)
    assert got.shape == (num_groups(n) * GROUP,) and same(got[:n], ref)


@pytest.mark.parametrize("n", [N, GROUP + 5])
def test_alp_exceptions_split_by_shard(n):
    """Prices salted with NaN, ±Inf, -0.0 and subnormals: exceptions in
    every shard, each written by its own shard's decode."""
    from test_torch_inputs import salted_prices

    col = gtt.encode(salted_prices(n, rng_of(f"dist/alp/{n}")), "alp")
    assert col.params["count"] > 0
    assert same(dist.decode_sharded(col, MESH).numpy(), gtt.decode_ref(col))


def test_host_chip_mesh_shards_over_both_axes():
    mesh, axes = dist.host_chip_mesh(2, 2, [CPU] * 4)
    assert mesh.shape == {"h": 2, "c": 2} and axes == ("h", "c")
    v = gen_column("delta", N, rng_of("dist/2d"))
    col = gtt.encode(v, "delta")
    assert same(dist.decode_sharded(col, mesh, axes).numpy(), v)


def test_one_device_may_hold_several_shards():
    mesh = dist.Mesh([CPU] * 3)
    assert mesh.size == 3 and mesh.first_device() == CPU and not mesh.multi_process()
    v = gen_column("nbit", N, rng_of("dist/three"))
    assert same(dist.decode_sharded(gtt.encode(v, "nbit"), mesh).numpy(), v)


def test_mesh_rejects_a_partial_axis():
    mesh, _ = dist.host_chip_mesh(2, 2, [CPU] * 4)
    with pytest.raises(NotImplementedError, match="replicas"):
        dist.decode_sharded(gtt.encode(np.arange(10, dtype=np.int32), "nbit"), mesh, "c")


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        assert dist.default_mesh().devices.flat[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.default_mesh()
    assert dist.default_mesh(devices=[CPU] * 2).shape == {"d": 2}


def test_replicated_streams_go_up_once_a_device():
    v = gen_column("dict", N, rng_of("dist/replicated"))
    shards = dist.place(gtt.encode(v, "dict"), MESH)
    values = [sh.streams["values"] for sh in shards if sh.col is not None]
    assert len(values) == 3 and all(t is values[0] for t in values)


# --- the two-process drill ------------------------------------------------------------

DRILL_SCHEMES = ["nbit", "dict", "rle", "patched"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def drill_worker(rank: int, port: int, results) -> None:
    """One process of the drill: its two shards of each column against
    the oracle, then the all-reduced scans."""
    import torch.distributed as tdist

    from giddy_tpu_torch import dist_query

    torch.set_num_threads(1)
    try:
        tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
        mesh, axes = dist.host_chip_mesh(2, 2, [CPU] * 4)
        lines = []
        for scheme in DRILL_SCHEMES:
            v = gen_column(scheme, 6 * GROUP + 421, rng_of(f"dist/drill/{scheme}"))
            col = gtt.encode(v, scheme)
            fn, args = dist.build_sharded_decoder(col, mesh, axes)
            outs = fn(*args)
            assert len(outs) == 2, len(outs)
            for g0, u in outs:
                rows = max(0, min(col.n - g0 * GROUP, u.numel()))
                assert np.array_equal(u.numpy()[:rows].view(v.dtype), v[g0 * GROUP : g0 * GROUP + rows]), scheme
            try:
                dist.decode_sharded(col, mesh, axes)
                raise AssertionError("a whole decode across processes did not raise")
            except ValueError:
                pass
            med = int(np.median(v))
            assert dist_query.count_where_sharded(col, "lt", med, mesh, axes) == int((v < med).sum()), scheme
            assert dist_query.sum_sharded(col, mesh, axes) == int(v.astype(np.int64).sum()), scheme
            assert dist_query.min_sharded(col, mesh, axes) == int(v.min()), scheme
            lines.append(f"{scheme}: ok")
        vocab = np.arange(9, dtype=np.int32) * 3 - 10
        rng = rng_of("dist/drill/groupby")
        kv = vocab[rng.integers(0, 9, 6 * GROUP + 77)]
        mv = rng.integers(-(2**20), 2**20, kv.size).astype(np.int32)
        r = dist_query.group_reduce_sharded(gtt.encode(kv, "cascade"), gtt.encode(mv, "for"),
                                            ("count", "sum", "min", "max"), mesh=mesh, axis=axes)
        codes = np.searchsorted(vocab, kv)
        for c in range(9):
            sel = mv[codes == c]
            assert (r.count[c], r.sum[c], r.min[c], r.max[c]) == (sel.size, sel.astype(np.int64).sum(), sel.min(),
                                                                   sel.max())
        lines.append("groupby: ok")
        # two real groups: process 1's shards are all padding and it still takes part in every all-reduce
        v = gen_column("nbit", GROUP + 5, rng_of("dist/drill/short"))
        col = gtt.encode(v, "nbit")
        assert dist_query.min_sharded(col, mesh, axes) == int(v.min())
        assert dist_query.max_sharded(col, mesh, axes) == int(v.max())
        assert dist_query.count_where_sharded(col, "ge", int(v[0]), mesh, axes) == int((v >= v[0]).sum())
        assert dist_query.sum_sharded(col, mesh, axes) == int(v.astype(np.int64).sum())
        lines.append("short: ok")
        tdist.barrier()
        tdist.destroy_process_group()
        results.put((rank, "\n".join(lines)))
    except BaseException as e:  # reported to the test, which fails
        results.put((rank, f"FAILED: {type(e).__name__}: {e}"))


def test_two_process_gloo_drill():
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=drill_worker, args=(r, port, results)) for r in range(2)]
    for p in procs:
        p.start()
    got = dict(results.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    for rank in (0, 1):
        assert got[rank].endswith("short: ok"), f"rank {rank}: {got[rank]}"
    assert all(p.exitcode == 0 for p in procs)

