"""giddy_tpu_torch's dzbv against giddy_tpu's, on the CPU: each of the three
stream forms (tile, group-row, on-disk planes) decoded through the plain
versions of K13, K14 and K15 against the JAX decoder of the same form
(Pallas interpret mode, or its XLA two-pass path for the planes), the NumPy
oracle and the input; the prep's choice of form, forced tile strides that
divide 128 and that straddle its windows, columns with no, one and three
planes above 0, narrow stores and n = 0. Everything is compared bit for bit
(tolerance 0). The host prep's bytes are held in test_torch_host.py. Last,
the shared memory the staged kernels take (kernels/_wrap.dzbv_plan), and a
NumPy model of K15's windows, the 4 KB rows of each plane that a group's
ranks touch, held to the plain version on short and skewed streams."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu.kernels import dzbv as gt_dzbv
from giddy_tpu_torch import kernels
from giddy_tpu_torch.kernels import _wrap, dzbv, lanes
from giddy_tpu_torch.ref.lmp import lmp_unpack
from giddy_tpu_torch.util import GROUP, LANES

from test_torch_host import assert_same_streams
from test_torch_inputs import JAX, dzbv_values, rng_of

N = 3 * GROUP + 17  # four groups, the last one ragged


# The JAX calls run in the worker's reference process (test_torch_inputs.JAX),
# so that the xdist worker keeps none of their interpret-mode programs.


def jax_decode_column(ref, **kw) -> np.ndarray:
    return np.asarray(gt.decode(ref, **kw))
FORMS = {"tile": "dzbv_tile_decode", "group": "dzbv_group_decode", "plane": "dzbv_plane_decode"}


def reference_form(ref, port_streams: dict, form: str) -> dict:
    """The reference's streams of the same form, forced to the port's strides
    or row widths."""
    if form == "tile":
        return gt_dzbv.tile_prep(ref, force_s={int(k[-1]): v.shape[1] // 64 for k, v in port_streams.items()
                                               if k.startswith("trow")})
    if form == "group":
        return gt_dzbv.group_prep(ref, force_w4={int(k[-1]): v.shape[1] // LANES for k, v in port_streams.items()
                                                 if k.startswith("prow")})
    return ref.streams


def jax_decode(ref, streams: dict) -> np.ndarray:
    """The reference's device decoder on these streams (its build picks the
    form from them, as the port's kernel_call does): (n_pad,) uint32."""
    return np.asarray(gt_dzbv.build(ref)({k: jnp.asarray(v) for k, v in streams.items()})).view(np.uint32)


def port_decode(col, streams: dict) -> tuple[str, torch.Tensor]:
    """(kernel name, (ng, GROUP) output) of the port's wrapper on the streams."""
    name, args = kernels.kernel_call(col, gtt.upload(streams, "cpu"), gtt.narrow_store_dtype(col))
    return name, getattr(kernels.WRAPPERS[name], name)(*args)


def check_form(v: np.ndarray, form: str, jax: bool = True, streams: dict | None = None):
    """The column of v in one form: same streams as the reference's, the
    form's kernel, output = JAX decode = oracle = input."""
    ref = gt.encode(v.view(np.int32), "dzbv", name="z")
    col = gtt.from_reference(ref)
    streams = dzbv.form_streams(col, form) if streams is None else streams
    name, out = port_decode(col, streams)
    assert name == FORMS[form] or (form != "plane" and not any(k[-1] in "123" for k in streams))
    got = out.numpy().reshape(-1).view(np.uint32)
    assert got[: v.shape[0]].tobytes() == gtt.decode_ref(col).view(np.uint32).tobytes() == v.tobytes()
    if jax:
        want = reference_form(ref, streams, form)
        assert_same_streams(streams, want)
        assert got.tobytes() == JAX(jax_decode, ref, want).tobytes()
    return col, streams


@pytest.mark.parametrize("n", [100, GROUP, N])
@pytest.mark.parametrize("form", list(FORMS))
def test_each_form_matches_jax_oracle_and_input(form, n):
    check_form(dzbv_values("mixed", n, rng_of(f"mixed{n}")), form)


# per_tile 4-byte values in every tile (all three planes), and the strides
# forced on planes 1, 2, 3: divisors of 128 and strides whose tiles straddle
# the reference's 128-lane windows (24, 40, 56, 88, 104, 120)
@pytest.mark.parametrize("per_tile,strides", [
    (5, (8, 8, 8)), (5, (24, 40, 120)), (16, (16, 24, 40)), (16, (32, 64, 128)),
    (50, (56, 88, 104)), (100, (104, 120, 128)), (128, (128, 128, 128)),
])
def test_forced_tile_strides(per_tile, strides):
    v = dzbv_values("per_tile", 2 * GROUP + 5, rng_of(f"tile{per_tile}"), per_tile=per_tile)
    col = gtt.encode(v, "dzbv")
    streams = dzbv.tile_prep(col, force_s=dict(zip((1, 2, 3), strides)))
    assert [streams[f"trow{k}"].shape[1] for k in (1, 2, 3)] == [64 * s for s in strides]
    check_form(v, "tile", jax=per_tile in (5, 100), streams=streams)


@pytest.mark.parametrize("kind,form", [("mixed", "tile"), ("skewed", "group"), ("group_skewed", "plane")])
def test_prep_picks_the_form(kind, form):
    """datagen's column takes the tile form at 8 groups; one 4-byte tile a
    group (tests/test_dzbv_layouts.py:61-72) the group-row form; one 4-byte
    group among 1-byte ones the on-disk planes. decode() goes the same way
    as giddy_tpu.decode."""
    v = dzbv_values(kind, 8 * GROUP if kind == "mixed" else N, rng_of(kind))
    ref = gt.encode(v.view(np.int32), "dzbv")
    col = gtt.from_reference(ref)
    streams = dzbv.prep(col)
    assert_same_streams(streams, gt_dzbv._prep(ref))
    assert kernels.kernel_call(col, gtt.upload(streams, "cpu"), torch.int32)[0] == FORMS[form]
    out = gtt.decode(col, device="cpu")
    assert out.numpy().tobytes() == JAX(jax_decode_column, ref).tobytes() == v.tobytes()
    assert dzbv.prep(dataclasses.replace(col, streams=streams)) is streams or form == "plane"


@pytest.mark.parametrize("kind,planes", [("one_byte", 0), ("two_bytes", 1), ("full", 3)])
@pytest.mark.parametrize("form", list(FORMS))
def test_planes_present(kind, planes, form):
    """No plane above 0 (every form decodes plane 0 alone, with K13 outside
    the plane form), plane 1 only, and full 32-bit values."""
    v = dzbv_values(kind, N, rng_of(kind))
    col, streams = check_form(v, form, jax=form == "tile")
    assert col.params["plane_lens"][1:] == [int((v > 0xFF).sum()), int((v > 0xFFFF).sum()), int((v > 0xFFFFFF).sum())]
    assert sum(col.params["plane_lens"][k] > 0 for k in (1, 2, 3)) == planes


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "float32"])
def test_narrow_stores_and_dtypes(dtype):
    u = dzbv_values("mixed", N, rng_of(dtype))
    v = u.view(np.float32) if dtype == "float32" else u.astype(np.dtype(dtype))
    ref = gt.encode(v, "dzbv")
    col = gtt.from_reference(ref)
    store = gtt.narrow_store_dtype(col)
    assert store == {1: torch.uint8, 2: torch.int16, 4: torch.int32}[v.itemsize]
    out = gtt.decode(col, device="cpu")
    signed = {4: torch.int32, 2: torch.int16, 1: torch.int8}[v.itemsize]
    assert out.dtype == getattr(torch, dtype)
    assert out.view(signed).numpy().tobytes() == JAX(jax_decode_column, ref).tobytes() == v.tobytes()
    for form in FORMS:
        name, args = kernels.kernel_call(col, gtt.upload(dzbv.form_streams(col, form), "cpu"), store)
        got = getattr(kernels.WRAPPERS[name], name)(*args)
        assert got.dtype == store and got.reshape(-1)[: v.shape[0]].numpy().tobytes() == v.tobytes()


def test_empty_column():
    ref = gt.encode(np.zeros(0, np.int32), "dzbv")
    col = gtt.from_reference(ref)
    assert col.params["plane_lens"] == [0, 0, 0, 0]
    assert gtt.decode(col, device="cpu").shape == (0,)
    padded = gtt.decode(col, device="cpu", pad=True)
    assert padded.shape == (GROUP,) and padded.numpy().tobytes() == JAX(jax_decode_column, ref, pad=True).tobytes()
    for form in FORMS:
        _, out = port_decode(col, dzbv.form_streams(col, form))
        assert out.shape == (1, GROUP) and not out.any()


@pytest.mark.parametrize("form", list(FORMS))
def test_kernel_call_names_the_form_and_cpu_launches_nothing(form):
    col = gtt.encode(dzbv_values("mixed", N, rng_of("names")).astype(np.int16), "dzbv")
    streams = gtt.upload(dzbv.form_streams(col, form), "cpu")
    name, args = kernels.kernel_call(col, streams, torch.int16)
    assert name == FORMS[form]
    before = kernels.launches()
    out = getattr(kernels.WRAPPERS[name], name)(*args)
    assert kernels.launches() == before
    assert out.dtype == torch.int16 and out.shape == (4, GROUP)
    assert torch.equal(out, getattr(lanes, name)(*args))


def _base(ng=2, dtype=torch.int32):
    return torch.zeros((ng, 2 * LANES), dtype=dtype), torch.zeros((ng, 8 * LANES), dtype=dtype)


def _rows(ng, words):
    return torch.zeros((ng, words), dtype=torch.int32)


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: dzbv.dzbv_tile_decode(*_base(dtype=torch.int64), (None, None, None)), TypeError),
        (lambda: dzbv.dzbv_tile_decode(_base()[0], _base(ng=3)[1], (None, None, None)), ValueError),
        (lambda: dzbv.dzbv_tile_decode(*_base(), (_rows(2, 64 * 12), None, None)), ValueError),  # s = 12
        (lambda: dzbv.dzbv_tile_decode(*_base(), (_rows(2, 64 * 136), None, None)), ValueError),  # s = 136
        (lambda: dzbv.dzbv_tile_decode(*_base(), (_rows(3, 64 * 8), None, None)), ValueError),  # 3 rows, ng 2
        (lambda: dzbv.dzbv_tile_decode(*_base(), (None, None)), ValueError),
        (lambda: dzbv.dzbv_tile_decode(*_base(), (None, None, None), torch.int64), TypeError),
        (lambda: dzbv.dzbv_group_decode(*_base(), (_rows(2, 9 * LANES), None, None)), ValueError),  # w4 = 9
        (lambda: dzbv.dzbv_group_decode(*_base(), (None, _rows(2, 1000), None)), ValueError),
        (lambda: dzbv.dzbv_plane_decode(*_base(), (_rows(5, 4 * LANES), None, None)), ValueError),
        (lambda: dzbv.dzbv_plane_decode(*_base(), (None, None, _rows(5, 8 * LANES).to(torch.int16))), TypeError),
        (lambda: dzbv.dzbv_plane_decode(*_base(), (None, None, _rows(5, 8 * LANES).to("meta"))), ValueError),
    ],
)
def test_wrappers_reject_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()


def test_plane_form_takes_rows_of_any_count():
    """K15 reads plane k from its own (rows_k, 8192) stream: a plane of 5
    groups beside widths of 2, and a column whose plane 3 is one group."""
    v = dzbv_values("mixed", N, rng_of("rows"))
    col = gtt.encode(v, "dzbv")
    assert [col.streams[f"plane{k}"].shape[0] for k in (1, 2, 3)] == [3, 2, 1]
    name, out = port_decode(col, col.streams)
    assert name == "dzbv_plane_decode" and out.reshape(-1)[:N].numpy().view(np.uint32).tobytes() == v.tobytes()
    widths, plane0 = _base()
    out = dzbv.dzbv_plane_decode(widths, plane0, (None, None, _rows(5, 8 * LANES)))
    assert out.shape == (2, GROUP) and not out.any()


H100_SHARED_PER_SM = 228 * 1024  # a block may opt in to 227 KB of it; the runtime keeps 1 KB a block
SHAPES = {"tile": range(8, 129, 8), "group": range(1, 9)}


@pytest.mark.parametrize("form,shape", [(form, a) for form, shapes in SHAPES.items() for a in shapes])
def test_dzbv_plan_fits_two_blocks_an_sm(form, shape):
    """K13 at every stride s and K14 at every row width w4, with planes {1},
    {1, 2} and {1, 2, 3} (and a hole at plane 2): a block's staged rows and
    static table fit the 227 KB opt-in, and two blocks of 1024 threads fit
    an SM, so the staging never halves the threads an SM holds."""
    for shapes in ((shape, None, None), (shape, shape, None), (shape, shape, shape), (shape, None, shape)):
        dynamic = _wrap.dzbv_plan(form, shapes)
        present = sum(a is not None for a in shapes)
        assert dynamic == present * _wrap.DZBV_ROW_UNIT[form] * shape and dynamic % 2048 == 0
        block = dynamic + _wrap.DZBV_STATIC
        assert block <= 227 * 1024
        assert 2 * (block + 1024) <= H100_SHARED_PER_SM


def test_dzbv_plan_at_the_2_26_cell():
    """The 2^26 dzbv column of chip_smoke.py stages 72 KB a group in the
    tile form (s 128, 96, 64) and 60 KB in the group-row form (w4 7, 5, 3)."""
    assert _wrap.dzbv_plan("tile", (128, 96, 64)) == 72 * 1024
    assert _wrap.dzbv_plan("group", (7, 5, 3)) == 60 * 1024
    assert _wrap.dzbv_plan("group", (None, 0, None)) == 0


@pytest.mark.parametrize("shapes", [(5, None, None), (5, 3, None), (5, None, 1), (None, 3, 1), (5, 3, 1)])
def test_dzbv_plan_of_the_on_disk_planes(shapes):
    """K15 sizes a block for 9 rows of 4 KB a present plane, whatever the
    streams' lengths: at three planes (110,592 B, the worst case) one block
    of 1024 threads fits an SM, at one or two planes two (the most threads
    an SM holds)."""
    dynamic = _wrap.dzbv_plan("plane", shapes)
    present = sum(a is not None for a in shapes)
    assert dynamic == present * _wrap.DZBV_PLANE_WINDOW == present * 36_864
    assert dynamic + _wrap.DZBV_STATIC <= 227 * 1024
    blocks = min(2, H100_SHARED_PER_SM // (dynamic + _wrap.DZBV_STATIC + 1024))  # 2048 threads an SM
    assert blocks == (1 if present == 3 else 2)


def window_model(widths: torch.Tensor, plane0: torch.Tensor, planes: tuple) -> np.ndarray:
    """K15 in NumPy, as csrc/dzbv_decode.cu stage_windows and phase 2 do it:
    each group's first rank r and count n in plane k, the rows r >> 12 ..
    (r + n - 1) >> 12 of the plane's 4 KB rows (in rank order), clamped to
    the stream and to 9, and each value's byte at min(r - 4096 * first row +
    its rank in the group, the window's last byte). (ng, GROUP) uint32."""
    codes = lmp_unpack(widths.numpy().view(np.uint32), 2, widths.shape[0] * GROUP).reshape(-1, GROUP)
    out = lmp_unpack(plane0.numpy().view(np.uint32), 8, plane0.shape[0] * GROUP).reshape(-1, GROUP)
    for k, plane in enumerate(planes, 1):
        if plane is None:
            continue
        rows = lmp_unpack(plane.numpy().view(np.uint32), 8, plane.shape[0] * GROUP).reshape(-1, 4096)
        mask = codes >= k
        counts = mask.sum(axis=1)
        for g, (r, n) in enumerate(zip(np.cumsum(counts) - counts, counts)):
            if n == 0:
                continue
            r0 = min(r >> 12, rows.shape[0] - 1)
            r1 = min((r + n - 1) >> 12, rows.shape[0] - 1, r0 + 8)
            window = rows[r0 : r1 + 1].reshape(-1)
            start = min(r - 4096 * r0, window.size - 1)
            rank = np.arange(n)
            out[g, mask[g]] |= window[np.minimum(start + rank, window.size - 1)].astype(np.uint32) << np.uint32(8 * k)
    return out


def _random_planes(rng, ng: int, plane_rows: tuple) -> tuple:
    words = lambda shape: torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))
    return words((ng, 2 * LANES)), words((ng, 8 * LANES)), tuple(
        None if a is None else words((a, 8 * LANES)) for a in plane_rows)


@pytest.mark.parametrize("case", ["windows", "group_skewed", "mixed", "random short", "random plane 2 absent",
                                  "random one row"])
def test_k15_window_model_matches_plain_version(case):
    """The windows K15 stages give the plain version's bytes: a middle
    group's 9 rows a plane from 100 bytes into a row, the last group's
    window at the stream's end, groups with no value in a plane, and random
    widths over streams far too short for them (ranks clamp to the stream's
    last byte, so the window shrinks to the stream's last rows or to its
    last row alone)."""
    if case.startswith("random"):
        rng = rng_of(f"windows/{case}")
        rows = {"random short": (1, 2, 3), "random plane 2 absent": (2, None, 1), "random one row": (1, 1, 1)}[case]
        widths, plane0, planes = _random_planes(rng, 5, rows)
    else:
        v = dzbv_values(case, 4 * GROUP, rng_of(f"windows/{case}")).view(np.int32)
        col = gtt.encode(v, "dzbv")
        name, (widths, plane0, planes, _) = kernels.kernel_call(col, gtt.upload(col.streams, "cpu"), torch.int32)
        assert name == "dzbv_plane_decode" and all(t is not None for t in planes)
    want = lanes.dzbv_plane_decode(widths, plane0, planes).numpy().view(np.uint32)
    assert window_model(widths, plane0, planes).tobytes() == want.tobytes()
    if case == "windows":
        assert want.reshape(-1).tobytes() == v.view(np.uint32).tobytes()
