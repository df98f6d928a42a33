"""giddy_tpu_torch.decode as a whole against giddy_tpu.decode and the input,
plus the API's contract: decoder cache, argument checks, what is not
ported yet, and that the port never imports JAX. The CUDA kernels' own
tests are in test_torch_cuda.py."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu_torch import api
from giddy_tpu_torch.kernels import delta, dict_, for_, nbit
from giddy_tpu_torch.util import GROUP

from helpers import gen_column

REPO = pathlib.Path(__file__).resolve().parent.parent
SCHEMES = ["nbit", "dzbf", "for", "delta", "dict"]


@pytest.fixture(scope="module")
def columns():
    """(values, reference column) per scheme: int32 and uint8 data."""
    rng = np.random.default_rng(41)
    out = {}
    for s in SCHEMES:
        v = gen_column(s, 2 * GROUP + 999, rng)
        out[s, "int32"] = (v, gt.encode(v, s))
        v8 = (v & 0xFF).astype(np.uint8)
        out[s, "uint8"] = (v8, gt.encode(v8, s))
    return out


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_matches_jax_and_input(columns, scheme, dtype):
    v, ref = columns[scheme, dtype]
    out = gtt.decode(gtt.from_reference(ref), device="cpu")
    assert out.dtype == getattr(torch, dtype) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.asarray(gt.decode(ref)))
    np.testing.assert_array_equal(out.numpy(), v)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_pad_and_empty(columns, scheme):
    v, ref = columns[scheme, "int32"]
    col = gtt.from_reference(ref)
    padded = gtt.decode(col, device="cpu", pad=True)
    assert padded.shape == (3 * GROUP,)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(gt.decode(ref, pad=True)))
    empty = gtt.decode(gtt.encode(np.zeros(0, np.int16), scheme), device="cpu")
    assert empty.shape == (0,) and empty.dtype == torch.int16


def test_decode_logical_dtypes():
    rng = np.random.default_rng(42)
    raw = rng.integers(0, 2**32, GROUP + 3, dtype=np.uint64).astype(np.uint32)
    for dtype, torch_dtype in [("uint32", torch.uint32), ("float32", torch.float32),
                               ("int16", torch.int16), ("uint16", torch.uint16), ("int8", torch.int8)]:
        v = raw.view(np.float32) if dtype == "float32" else raw.astype(np.dtype(dtype))
        out = gtt.decode(gtt.encode(v, "nbit"), device="cpu")
        assert out.dtype == torch_dtype and out.shape == (v.shape[0],)
        signed = {4: torch.int32, 2: torch.int16, 1: torch.int8}[v.itemsize]
        assert out.view(signed).numpy().tobytes() == v.tobytes()
    # a full-width payload of a narrow column truncates, as the reference's _to_logical
    payload = torch.tensor([0x1FF, 0x12345], dtype=torch.int32)
    assert api._to_logical(payload, "int8").tolist() == [-1, 69]
    assert api._to_logical(payload, "uint16").view(torch.int16).tolist() == [0x1FF, 0x2345]


def test_decoder_cache_reuse():
    rng = np.random.default_rng(8)
    v = gen_column("nbit", GROUP, rng)
    col1 = gtt.encode(v, "nbit", bits=10)
    col2 = gtt.encode(v + 1, "nbit", bits=10)
    assert gtt.get_decoder(col1) is gtt.get_decoder(col2)
    assert gtt.get_decoder(col1, torch.int16) is not gtt.get_decoder(col1)
    assert gtt.narrow_store_dtype(gtt.encode(v.astype(np.int8), "nbit")) == torch.uint8
    assert gtt.narrow_store_dtype(col1) == torch.int32


def _packed(ng=2, bits=9, dtype=torch.int32):
    return torch.zeros((ng, bits * 1024), dtype=dtype)


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: nbit.lmp_unpack(_packed(dtype=torch.int64), 9), TypeError),
        (lambda: nbit.lmp_unpack(_packed().view(torch.uint32), 9), TypeError),
        (lambda: nbit.lmp_unpack(_packed(), 10), ValueError),
        (lambda: nbit.lmp_unpack(_packed(bits=33), 33), ValueError),
        (lambda: nbit.lmp_unpack(_packed(ng=0), 9), ValueError),
        (lambda: nbit.lmp_unpack(_packed().reshape(-1), 9), ValueError),
        (lambda: nbit.lmp_unpack(_packed(bits=2).t().contiguous().t(), 2), ValueError),
        (lambda: nbit.lmp_unpack(_packed(), 9, torch.int64), TypeError),
        (lambda: for_.for_unpack(_packed(), torch.zeros(3, dtype=torch.int32), 9), ValueError),
        (lambda: for_.for_unpack(_packed(), torch.zeros(2, dtype=torch.int64), 9), TypeError),
        (lambda: delta.delta_decode(_packed(), torch.zeros((2, 1), dtype=torch.int32), 9), ValueError),
        (lambda: dict_.dict_decode(_packed(), torch.zeros(0, dtype=torch.int32), 9), ValueError),
        (lambda: dict_.dict_decode(_packed(), torch.zeros(8, dtype=torch.int32)[::2], 9), ValueError),
        (lambda: nbit.lmp_unpack(_packed().to("meta"), 9), ValueError),
    ],
)
def test_wrappers_reject_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()


def test_unported_schemes_dtypes_and_sizes_raise():
    """Every scheme of the reference is ported (wide and strdict decode
    here); what stays refused: an unknown scheme, a 64-bit dtype on a
    scheme other than wide, n_pad >= 2^31 in one device call (decode
    chunks such a column) and a device that is neither the card nor the
    CPU."""
    assert gtt.registry.PENDING == {}
    rng = np.random.default_rng(9)
    v = gen_column("wide", 100, rng)
    wide = gt.encode(v, "wide")
    got = gtt.decode(gtt.from_reference(wide), device="cpu")
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), v)
    port = gtt.encode(np.zeros(10, np.int64), "wide")
    ref = gt.encode(np.zeros(10, np.int64), "wide")
    assert port.params == ref.params and all(port.streams[k].tobytes() == ref.streams[k].tobytes() for k in ref.streams)
    strs = gt.strings.encode_strings(["b", "a", "b"])
    assert list(gtt.decode(gtt.from_reference(strs), device="cpu")) == ["b", "a", "b"]
    with pytest.raises(KeyError, match="not registered"):
        gtt.get("no_such_scheme")
    col = gtt.encode(np.zeros(10, np.int32), "nbit")
    col.dtype = "int64"
    with pytest.raises(NotImplementedError, match="'wide' scheme"):
        gtt.decode(col, device="cpu")
    col = gtt.encode(np.zeros(10, np.int32), "nbit")
    col.n = 2**31  # decode takes such a column in chunks (test_torch_bigcolumn.py); one call refuses it
    with pytest.raises(NotImplementedError, match="addressing limit"):
        gtt.get_decoder(col)
    with pytest.raises(ValueError, match="no decoder for device"):
        gtt.decode(gtt.encode(np.zeros(10, np.int32), "nbit"), device="meta")


def test_entry_points_default_to_the_card():
    """Called without ``device``, every entry point runs on the card: here,
    with none, it raises rather than falling back to the CPU."""
    from giddy_tpu_torch import aggregate, groupby, nulls, partial, query, strings, topk, zonemap

    col = gtt.encode(np.arange(GROUP + 5, dtype=np.int32), "nbit")
    keys = gtt.encode(np.arange(GROUP + 5, dtype=np.int32) % 7, "dict")
    strs = gtt.from_reference(gt.strings.encode_strings(["x", "y"] * 3))
    calls = [
        lambda: gtt.decode(col), lambda: gtt.decode_columns([col]), lambda: query.count_where(col, "lt", 3),
        lambda: query.filter_bitmap(col, "lt", 3), lambda: query.isin_bitmap(col, [1]),
        lambda: query.select_where(col, "lt", 3), lambda: aggregate.sum_(col), lambda: aggregate.min_(col),
        lambda: nulls.decode_masked(col), lambda: groupby.group_reduce(keys, col, ("sum",)),
        lambda: topk.top_k(col, 3), lambda: partial.take(col, [1]), lambda: partial.decode_groups(col, 0, 1),
        lambda: zonemap.count_where_pruned(col, "eq", GROUP + 1), lambda: strings.decode(strs),
        lambda: strings.filter_bitmap_str(strs, "eq", "x"),
    ]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_decode_on_cuda_without_gpu_raises(columns):
    v, ref = columns["nbit", "int32"]
    col = gtt.from_reference(ref)
    if torch.cuda.is_available():
        np.testing.assert_array_equal(gtt.decode(col, device="cuda").cpu().numpy(), v)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gtt.decode(col, device="cuda")


def test_import_leaves_jax_out():
    code = (
        "import sys, giddy_tpu_torch, chip_smoke; "
        "import giddy_tpu_torch.query, giddy_tpu_torch.aggregate, giddy_tpu_torch.nulls, giddy_tpu_torch.groupby, "
        "giddy_tpu_torch.wide, giddy_tpu_torch.strings, giddy_tpu_torch.dist, giddy_tpu_torch.partial, "
        "giddy_tpu_torch.zonemap, giddy_tpu_torch.topk, giddy_tpu_torch.layout, giddy_tpu_torch.advisor, "
        "giddy_tpu_torch.stream, giddy_tpu_torch.table, giddy_tpu_torch.join, giddy_tpu_torch.dataset, "
        "giddy_tpu_torch.cli, giddy_tpu_torch.selftest, bench_torch; "
        "sys.path.insert(0, 'scripts'); import multihost_bench_torch; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'giddy_tpu')); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_version_is_the_reference_package_version():
    """The port keeps its own literal of the project's version, which
    giddy_tpu carries too."""
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        version = tomllib.load(f)["project"]["version"]
    assert gtt.__version__ == gt.__version__ == version == "0.1.0"


def test_upload_copies_a_read_only_container_on_the_cpu(tmp_path):
    """A container's streams are read-only (``Table.open`` maps the file,
    ``read_container`` views the bytes): on the CPU, upload copies them, so
    no tensor aliases the container's buffer, and a decode of an opened
    table raises no UserWarning (checked in a fresh process, since torch
    warns once a process)."""
    from giddy_tpu_torch.table import Table

    v = (np.arange(3 * GROUP + 7) % 500).astype(np.int32)
    r = np.repeat(v[::64], 64)[: v.size]
    t = Table.from_arrays({"x": v, "r": r}, {"x": "nbit", "r": "rle"}, device="cpu")
    path = tmp_path / "t.gtp"
    t.save(str(path))
    opened = Table.open(str(path), device="cpu")
    for cols in ([opened[nm] for nm in opened.names], gtt.read_container(t.to_bytes())):
        for col in cols:
            assert not any(s.flags.writeable for s in col.streams.values())
            up = gtt.upload(col.streams, "cpu")
            assert not any(np.shares_memory(up[k].numpy(), s) for k, s in col.streams.items())
            np.testing.assert_array_equal(gtt.decode(col, device="cpu").numpy(), t.select([col.name])[col.name])
    code = (
        "import numpy as np; from giddy_tpu_torch.table import Table; "
        f"t = Table.open({str(path)!r}, device='cpu'); "
        f"assert t.count(('x', 'lt', 100)) == {int((v < 100).sum())} and t.agg('r', 'max') == {int(r.max())}; "
        "[t.select([nm]) for nm in t.names]"
    )
    subprocess.run([sys.executable, "-W", "error::UserWarning", "-c", code], cwd=REPO, check=True, timeout=120)
