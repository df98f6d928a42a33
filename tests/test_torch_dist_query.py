"""giddy_tpu_torch.dist_query, the strdict twins and ``mesh=`` on joins and
datasets against the reference's sharded scans, on the CPU, tolerance 0.

The reference (giddy_tpu.dist_query, giddy_tpu.strings, giddy_tpu.join,
giddy_tpu.table and giddy_tpu.dataset with ``mesh=``) runs on a 4-device
virtual CPU mesh (the first four devices of tests/conftest.py's XLA flags;
Pallas in interpret mode) in the worker's reference process, part by part
(a case's scans, the string twins, the joins, the dataset), each part once
per run (test_torch_inputs.ReferenceParts); the port runs on ``dist.Mesh([cpu] * 4)``.
Inputs: nbit, dict, rle, patched (compressed positions), dzbv (the group
skew that declines the group-row form), a nullable FOR column and a wide
column at n = 5·GROUP + 421 (six groups over four shards); the scans are
filter_bitmap_sharded (whole words, pad bits zero) and count_where_sharded
at two ops, isin, sum, min, max and group_reduce_sharded with count, sum,
min and max."""

import functools

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import dataset, dist, dist_query, strings, table
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX, PRIORITIES, ReferenceParts, once_per_run, rng_of

CPU = torch.device("cpu")
MESH = dist.Mesh([CPU] * 4)
N = 5 * GROUP + 421
CASES = ["nbit", "dict", "rle", "patched-compressed", "dzbv-skew", "for-nullable", "wide"]
AGGS = ("count", "sum", "min", "max")
STR_PREDICATES = [("eq", "3-MEDIUM"), ("ge", "2-HIGH"), ("startswith", "4"), ("lt", "0")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def values(label: str):
    """(values, valid or None, scheme, encode options) of a case."""
    rng = rng_of(f"dist_query/{label}")
    if label == "patched-compressed":
        return gen_column("patched", N, rng), None, "patched", {"kind": "compressed"}
    if label == "dzbv-skew":
        return np.sort(gen_column("dzbv", N, rng).view(np.uint32)).view(np.int32), None, "dzbv", {}
    if label == "for-nullable":
        return gen_column("for", N, rng), rng.random(N) > 0.1, "for", {}
    if label == "wide":
        return rng.integers(-(2**40), 2**40, N, dtype=np.int64), None, "wide", {}
    return gen_column(label, N, rng), None, label, {}


def thresholds(label: str) -> tuple:
    v, valid, _, _ = values(label)
    live = v if valid is None else v[valid]
    return int(np.median(live)), int(np.quantile(live, 0.9))


def isin_set(label: str) -> list:
    v = values(label)[0]
    u = np.unique(v)
    return [int(x) for x in u[:: max(1, u.size // 20)]]


def group_keys():
    """A 12-entry cascade key column's values, and a nullable dict key's."""
    rng = rng_of("dist_query/keys")
    vocab = np.arange(12, dtype=np.int32) * 5 - 20
    return vocab[rng.integers(0, 12, N)], rng.random(N) > 0.05


def strings_values() -> list:
    rng = rng_of("dist_query/strings")
    return [PRIORITIES[i] for i in np.repeat(rng.integers(0, 5, N // 40 + 1), 40)[:N]]


def join_sides():
    """(left keys, right keys, left measure): int32 keys from two
    overlapping ranges, some rows with many partners and some with none."""
    rng = rng_of("dist_query/join")
    n = 2 * GROUP + 999
    return (rng.integers(0, 3000, n).astype(np.int32), rng.integers(2000, 6000, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32))


def partitions() -> list[dict]:
    rng = rng_of("dist_query/dataset")
    return [{"x": rng.integers(0, 5000, GROUP + 99 * (i + 1)).astype(np.int32),
             "s": np.array(PRIORITIES, dtype=object)[rng.integers(0, 5, GROUP + 99 * (i + 1))]}
            for i in range(3)]


DATASET_PREDICATES = [[("x", "lt", 1200)], [("x", "ge", 100), ("s", "eq", "1-URGENT")], [("x", "lt", 0)]]


def scans(dq, encode, mesh, label: str) -> dict:
    """Every scan of this file of one case in one package: ``dq`` its
    dist_query, ``encode`` its encode (values, scheme, **opts)."""
    keys_v, kvalid = group_keys()
    v, valid, scheme, opts = values(label)
    col = encode(v, scheme, name=label, valid=valid, **opts)
    lo, hi = thresholds(label)
    out = {
        "filter": np.asarray(dq.filter_bitmap_sharded(col, "lt", lo, mesh)).view(np.uint32),
        "count": dq.count_where_sharded(col, "ge", hi, mesh),
        "isin": dq.isin_count_sharded(col, isin_set(label), mesh),
        "sum": dq.sum_sharded(col, mesh),
        "min": dq.min_sharded(col, mesh),
        "max": dq.max_sharded(col, mesh),
    }
    for kname, keys in (("cascade", encode(keys_v, "cascade")), ("dict-nullable", encode(keys_v, "dict", valid=kvalid))):
        r = dq.group_reduce_sharded(keys, col, AGGS, mesh=mesh)
        out["groupby", kname] = {f: np.asarray(getattr(r, f)) for f in ("keys",) + AGGS}
    return out


def reference_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:4]), ("d",))


def reference_part(part: str) -> dict:
    """The reference's answers of one CASES label, of the string twins or
    of the joins (run in the worker's reference process)."""
    import giddy_tpu as gt
    from giddy_tpu import dist_query as jdq
    from giddy_tpu import strings as jstrings
    from giddy_tpu import table as jtable

    mesh, out = reference_mesh(), {}
    if part in CASES:
        return scans(jdq, gt.encode, mesh, part)
    if part == "strings":
        scol = jstrings.encode_strings(strings_values(), codes_scheme="rle")
        for op, v in STR_PREDICATES:
            out["filter", op, v] = np.asarray(jstrings.filter_bitmap_str_sharded(scol, op, v, mesh)).view(np.uint32)
            out["count", op, v] = jstrings.count_where_str_sharded(scol, op, v, mesh)
        return out
    if part != "joins":
        raise ValueError(part)
    lk, rk, lx = join_sides()
    left = jtable.Table.from_arrays({"k": lk, "x": lx}, {"k": "nbit", "x": "nbit"})
    right = jtable.Table.from_arrays({"k": rk}, {"k": "dict"})
    for how in ("inner", "left", "outer"):
        out["join_indices", how] = gt.join_indices(left["k"], right["k"], mesh=mesh, how=how)
    rows, li, ri = left.join("k", right, mesh=mesh)
    out["Table.join"] = ({k: np.asarray(v) for k, v in rows.items()}, li, ri)
    out["semi_join"] = np.asarray(jdq.semi_join_bitmap_sharded(left["k"], right["k"], mesh)).view(np.uint32)
    return out


def reference_dataset(root: str) -> dict:
    """The reference writes ``root/ds`` and answers its counts and
    aggregates with ``mesh=`` (run in the worker's reference process)."""
    from giddy_tpu import dataset as jds
    from giddy_tpu import table as jtable

    mesh = reference_mesh()
    jds.Dataset.write(f"{root}/ds", [jtable.Table.from_arrays(p, {"x": "nbit", "s": "strdict"}) for p in partitions()])
    ds = jds.Dataset.open(f"{root}/ds")
    out = {("count", i): ds.count(*preds, mesh=mesh) for i, preds in enumerate(DATASET_PREDICATES)}
    out["agg"] = (ds.agg("x", "sum", mesh=mesh), ds.agg("x", "avg", mesh=mesh))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """ref(part): the reference's answers of that part, computed once per
    run."""
    return ReferenceParts(tmp_path_factory, "dist_query", reference_part)


@pytest.fixture(scope="module")
def ref_dataset(tmp_path_factory):
    """(root, the reference's answers on the dataset it wrote there), once
    per run."""
    return once_per_run(tmp_path_factory, "dist_query-dataset", lambda root: JAX(reference_dataset, str(root)))


@functools.cache
def port(label: str) -> dict:
    return scans(dist_query, gtt.encode, MESH, label)


def same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.tolist() == b.tolist()
    return type(a) is type(b) and a == b if isinstance(a, float) else a == b


@pytest.mark.parametrize("what", ["filter", "count", "isin", "sum", "min", "max"])
@pytest.mark.parametrize("label", CASES)
def test_scan_matches_the_reference(ref, what, label):
    got, want = port(label)[what], ref(label)[what]
    if what == "filter":
        assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape == (6, 1024)
        assert got.tobytes() == want.tobytes()
    else:
        assert same(got, want), (got, want)


@pytest.mark.parametrize("keys", ["cascade", "dict-nullable"])
@pytest.mark.parametrize("label", CASES)
def test_group_reduce_matches_the_reference(ref, keys, label):
    got, want = port(label)["groupby", keys], ref(label)["groupby", keys]
    nonempty = want["count"] > 0  # empty groups' extremes are identities in either package
    for f in ("keys", "count", "sum"):
        assert same(got[f], want[f]), f
    for f in ("min", "max"):
        assert same(got[f][nonempty], want[f][nonempty]), f


@pytest.mark.parametrize("pred", STR_PREDICATES, ids=[f"{op}-{v}" for op, v in STR_PREDICATES])
def test_string_twins_match_the_reference(ref, pred):
    scol = strings.encode_strings(strings_values(), codes_scheme="rle")
    op, v = pred
    got = strings.filter_bitmap_str_sharded(scol, op, v, MESH).numpy().view(np.uint32)
    want = ref("strings")
    assert got.tobytes() == want["filter", op, v].tobytes()
    assert strings.count_where_str_sharded(scol, op, v, MESH) == want["count", op, v]


def port_join_tables():
    lk, rk, lx = join_sides()
    left = table.Table.from_arrays({"k": lk, "x": lx}, {"k": "nbit", "x": "nbit"}, device=CPU)
    right = table.Table.from_arrays({"k": rk}, {"k": "dict"}, device=CPU)
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_join_indices_with_a_mesh(ref, how):
    left, right = port_join_tables()
    li, ri = gtt.join_indices(left["k"], right["k"], mesh=MESH, how=how, device=CPU)
    want = ref("joins")["join_indices", how]
    assert np.array_equal(li, want[0]) and np.array_equal(ri, want[1])
    plain = gtt.join_indices(left["k"], right["k"], how=how, device=CPU)
    assert np.array_equal(li, plain[0]) and np.array_equal(ri, plain[1])


def test_table_join_with_a_mesh(ref):
    left, right = port_join_tables()
    rows, li, ri = left.join("k", right, mesh=MESH)
    want_rows, want_li, want_ri = ref("joins")["Table.join"]
    assert np.array_equal(li, want_li) and np.array_equal(ri, want_ri)
    assert sorted(rows) == sorted(want_rows)
    for k in rows:
        assert np.array_equal(rows[k], want_rows[k]), k


def test_semi_join_with_a_mesh(ref):
    left, right = port_join_tables()
    got = dist_query.semi_join_bitmap_sharded(left["k"], right["k"], MESH).numpy().view(np.uint32)
    assert got.tobytes() == ref("joins")["semi_join"].tobytes()


@pytest.fixture(scope="module")
def port_dataset(ref_dataset):
    return dataset.Dataset.open(f"{ref_dataset[0]}/ds", device=CPU)


@pytest.mark.parametrize("i", range(len(DATASET_PREDICATES)))
def test_dataset_count_with_a_mesh(ref_dataset, port_dataset, i):
    assert port_dataset.count(*DATASET_PREDICATES[i], mesh=MESH) == ref_dataset[1]["count", i]
    assert port_dataset.count(*DATASET_PREDICATES[i]) == ref_dataset[1]["count", i]


def test_dataset_agg_with_a_mesh(ref_dataset, port_dataset):
    got = (port_dataset.agg("x", "sum", mesh=MESH), port_dataset.agg("x", "avg", mesh=MESH))
    assert got == ref_dataset[1]["agg"]


def test_scan_rejects_an_unknown_op():
    with pytest.raises(ValueError, match="op must be one of"):
        dist_query.count_where_sharded(gtt.encode(np.arange(9, dtype=np.int32), "nbit"), "approx", 1, MESH)


def test_min_of_an_empty_or_all_null_column_raises():
    with pytest.raises(ValueError, match="empty"):
        dist_query.min_sharded(gtt.encode(np.zeros(0, np.int32), "nbit"), MESH)
    col = gtt.encode(np.arange(100, dtype=np.int32), "nbit", valid=np.zeros(100, bool))
    with pytest.raises(ValueError, match="all-null"):
        dist_query.max_sharded(col, MESH)


def test_empty_column_scans():
    col = gtt.encode(np.zeros(0, np.int32), "nbit")
    words = dist_query.filter_bitmap_sharded(col, "lt", 5, MESH)
    assert words.shape == (1, 1024) and not words.any()
    assert dist_query.count_where_sharded(col, "lt", 5, MESH) == 0 and dist_query.sum_sharded(col, MESH) == 0
