"""giddy_tpu_torch.kernels.encode (device encode, K18 lmp_pack) against
giddy_tpu.kernels.encode and against the port's own host encoders, on the
CPU. There the port's tensor functions run K18's plain PyTorch version
(kernels/lanes.py) and the reference runs its Pallas pack in interpret
mode, as tests/test_encode_device.py runs it. Every stream is compared bit
for bit (tolerance 0), and every device-encoded column decodes back to its
input through ``decode(col, device="cpu")``. Each reference call is a fresh
interpret-mode trace, so the JAX cases stay at n <= 3 GROUP. The CUDA
kernel is held to the same plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from giddy_tpu.kernels import encode as jax_encode

import giddy_tpu_torch as gtt
from giddy_tpu_torch import kernels
from giddy_tpu_torch.format import EncodedColumn
from giddy_tpu_torch.kernels import encode, lanes
from giddy_tpu_torch.ref import delta as ref_delta
from giddy_tpu_torch.ref import dict_ as ref_dict
from giddy_tpu_torch.ref import for_ as ref_for
from giddy_tpu_torch.ref import lmp as ref_lmp
from giddy_tpu_torch.ref import nbit as ref_nbit
from giddy_tpu_torch.ref import rle as ref_rle
from giddy_tpu_torch.util import GROUP, LANES, pad_to_groups, zigzag

from test_torch_inputs import DICT_KINDS, assert_same_column, dict_values, for_values, rng_of, wrapping_walk

N = 2 * GROUP + 5  # three groups, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The cases run many small torch ops; beside the other test workers,
    torch's thread pool only adds contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _uint(bits: int, n: int, seed: str) -> np.ndarray:
    return rng_of(seed).integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32)


def _decodes_to(col: EncodedColumn, v: np.ndarray) -> None:
    out = gtt.decode(col, device="cpu")
    assert out.numpy().tobytes() == v.tobytes()


def _launches_none(fn):
    """fn() on CPU tensors, which must launch no kernel."""
    before = kernels.launches()
    out = fn()
    assert kernels.launches() == before
    return out


# (bits, bits of the values): the last case is out of range for its width,
# so its high bits spill into the next slots and words as in the reference
@pytest.mark.parametrize("bits,value_bits", [(1, 1), (9, 9), (17, 17), (32, 32), (5, 32)])
def test_plain_pack_matches_jax(bits, value_bits):
    u = pad_to_groups(_uint(value_bits, N, f"pack/{bits}/{value_bits}"))
    got = _launches_none(lambda: encode.nbit_pack_device(_tensor(u), bits))
    assert got.dtype == torch.int32 and got.shape == (3, bits * LANES)
    want = np.asarray(jax_encode.nbit_pack_device(jnp.asarray(u), bits))
    assert _u32(got).tobytes() == want.tobytes()


@pytest.mark.parametrize("bits", range(1, 33))
def test_plain_pack_matches_host_and_unpacks(bits):
    u = _uint(bits, N, f"host/{bits}")
    got = encode.nbit_pack_device(_tensor(pad_to_groups(u)), bits)
    assert _u32(got).tobytes() == ref_lmp.lmp_pack(u, bits).tobytes()
    assert _u32(lanes.unpack_lanes(got, bits)).reshape(-1)[:N].tobytes() == u.tobytes()


@pytest.mark.parametrize("prologue", ["for_sub", "delta_zigzag"])
def test_plain_pack_prologues_match_numpy(prologue):
    """The fused transforms against NumPy: the FOR subtract of a frame's
    reference (frames of 2 GROUP over three groups, refs at both ends of
    the range) and the masked, zigzagged difference."""
    u = _uint(32, 3 * GROUP, f"prologue/{prologue}")
    n = N
    if prologue == "for_sub":
        refs = np.array([2**31 + 7, 5], np.uint32)
        want = u - np.repeat(refs, 2 * GROUP)[: u.shape[0]]
        got = encode.lmp_pack(_tensor(u).view(3, GROUP), 32, prologue, refs=_tensor(refs), frame_len=2 * GROUP)
    else:
        d = np.zeros(u.shape[0], np.int32)
        d[1:n] = (u[1:n] - u[: n - 1]).view(np.int32)
        want = zigzag(d)
        got = encode.lmp_pack(_tensor(u).view(3, GROUP), 32, prologue, n=n)
    assert _u32(got).tobytes() == ref_lmp.lmp_pack(want, 32).tobytes()


NBIT_DTYPES = ["int8", "int16", "uint16", "int32", "float32"]


@pytest.mark.parametrize("n", [0, 1, N])
@pytest.mark.parametrize("dtype", NBIT_DTYPES)
def test_encode_nbit_device(dtype, n):
    """Full-range values of each dtype (narrow payloads zero-extend, floats
    ride as their bits) at the dtype's width."""
    dt = np.dtype(dtype)
    v = _uint(8 * dt.itemsize, n, f"nbit/{dtype}/{n}").astype(np.dtype(f"uint{8 * dt.itemsize}")).view(dt)
    bits = 8 * dt.itemsize
    col = _launches_none(lambda: encode.encode_nbit_device(v, bits=bits, name="c", device="cpu"))
    assert_same_column(col, ref_nbit.encode(v, bits=bits, name="c"))
    want = jax_encode.encode_nbit_device(v, bits=bits, name="c")
    assert col.streams["packed"].tobytes() == want.streams["packed"].tobytes()
    _decodes_to(col, v)


def _frames(v: np.ndarray, frame_len: int) -> np.ndarray:
    """Payloads padded to whole frames with the last value, as ref/for_.py pads."""
    u = v.view(np.uint32)
    nf = -(-pad_to_groups(u).shape[0] // frame_len)
    out = np.full(nf * frame_len, u[-1], np.uint32)
    out[: u.shape[0]] = u
    return out


@pytest.mark.parametrize("frame_len", [GROUP, 2 * GROUP])
def test_for_streams_device(frame_len):
    """Values on both sides of the sign boundary, so the reference must be
    the unsigned min. At frame_len 2 GROUP the three groups pad to four:
    the reference packs them all, the host encoder its three."""
    v = for_values(N, rng_of(f"for/{frame_len}"))
    host = ref_for.encode(v, frame_len=frame_len)
    bits = host.params["bits"]
    u = _frames(v, frame_len)
    packed, refs = _launches_none(lambda: encode.for_streams_device(_tensor(u), bits, frame_len))
    want_packed, want_refs = jax_encode.for_streams_device(jnp.asarray(u), bits, frame_len)
    assert _u32(packed).tobytes() == np.asarray(want_packed).tobytes()
    assert _u32(refs).tobytes() == np.asarray(want_refs).tobytes()
    ng = host.streams["packed"].shape[0]
    assert packed.shape[0] == (4 if frame_len == 2 * GROUP else 3) and ng == 3
    assert _u32(packed[:ng]).tobytes() == host.streams["packed"].tobytes()
    assert refs.numpy().tobytes() == host.streams["refs"].tobytes()
    col = EncodedColumn(name="col", scheme="for", dtype="int32", n=N, params=host.params,
                        streams={"packed": _u32(packed[:ng]), "refs": refs.numpy()})
    _decodes_to(col, v)


@pytest.mark.parametrize("data", ["wrapping walk", "timestamps"])
def test_delta_streams_device(data):
    """A ragged n; the walk's deltas cross the int32 wrap both ways (so a
    zigzag with the wrong sign shows), the timestamps pack to 4 bits."""
    n = 3 * GROUP + 11
    rng = rng_of(f"delta/{data}")
    if data == "wrapping walk":
        v = wrapping_walk(n, rng)
    else:
        v = (np.cumsum(rng.integers(0, 8, n)) + 1_600_000_000).astype(np.int32)
    host = ref_delta.encode(v)
    bits = host.params["bits"]
    assert bits == (32 if data == "wrapping walk" else 4)
    u = pad_to_groups(v.view(np.uint32))
    packed, anchors = _launches_none(lambda: encode.delta_streams_device(_tensor(u), bits, n=n))
    want_packed, want_anchors = jax_encode.delta_streams_device(jnp.asarray(u), bits, n=n)
    assert _u32(packed).tobytes() == np.asarray(want_packed).tobytes()
    assert _u32(anchors).tobytes() == np.asarray(want_anchors).tobytes()
    col = EncodedColumn(name="col", scheme="delta", dtype="int32", n=n, params=host.params,
                        streams={"packed": _u32(packed), "anchors": anchors.numpy()})
    assert_same_column(col, host)
    _decodes_to(col, v)


def _rle_values(case: str) -> np.ndarray:
    if case == "distinct":
        return np.arange(GROUP + 17, dtype=np.int32)
    if case == "equal":
        return np.full(GROUP + 17, -7, np.int32)
    n = int(case)
    return np.repeat(rng_of(f"rle/{n}").integers(-50, 50, n // 40 + 1).astype(np.int32), 40)[:n]


@pytest.mark.parametrize("case", [str(2 * GROUP), str(3 * GROUP + 421), "177", "1", "0", "distinct", "equal"])
def test_encode_rle_device(case):
    """tests/test_encode_device.py's sizes, an empty column (one group of
    zeros, r_pad 8), runs of one and one run a group."""
    v = _rle_values(case)
    col = _launches_none(lambda: encode.encode_rle_device(v, name="c", device="cpu"))
    assert_same_column(col, ref_rle.encode(v, name="c"))
    want = jax_encode.encode_rle_device(v, name="c")
    assert col.params == want.params
    for s in ("run_values", "run_ends", "run_counts"):
        assert col.streams[s].tobytes() == np.asarray(want.streams[s]).tobytes(), s
    if case == "0":
        assert col.params["r_pad"] == 8 and col.streams["run_counts"].tolist() == [1]
    _decodes_to(col, v)


@pytest.mark.parametrize("kind", DICT_KINDS)
def test_encode_dict_device(kind):
    """Negative ints (the dictionary's logical order is not its payload
    order), uint32 on both sides of 2^31 (an unsigned search), floats with
    -0.0, NaN and -NaN (bit patterns, not values) and narrow signed ints."""
    v = dict_values(kind, N, rng_of(f"dict/{kind}"))
    col = _launches_none(lambda: encode.encode_dict_device(v, name="c", device="cpu"))
    assert_same_column(col, ref_dict.encode(v, name="c"))
    want = jax_encode.encode_dict_device(v, name="c")
    assert col.params == want.params
    for s in ("codes", "values"):
        assert col.streams[s].tobytes() == np.asarray(want.streams[s]).tobytes(), s
    _decodes_to(col, v)


def test_encode_dict_device_empty_follows_the_host_encoder():
    """At n = 0 the reference's device encoder raises (its gather into an
    empty code_of_rank, giddy_tpu/kernels/encode.py:243-244); the port
    returns the host encoder's column and launches nothing (ROADMAP.md §3)."""
    v = np.zeros(0, np.int32)
    with pytest.raises(TypeError):
        jax_encode.encode_dict_device(v)
    col = _launches_none(lambda: encode.encode_dict_device(v, name="c", device="cpu"))
    assert_same_column(col, ref_dict.encode(v, name="c"))
    assert col.params == {"bits": 1, "dict_size": 0, "dense": True} and col.streams["codes"].shape == (1, LANES)
    assert gtt.decode(col, device="cpu").shape == (0,)


def test_dict_codes_device_searches_unsigned_and_masks_the_tail():
    staged = torch.tensor([1, 2**31 - 1, -(2**31), -1], dtype=torch.int32)  # payload order: 1 < 2^31-1 < 2^31 < 2^32-1
    code_of_rank = torch.tensor([3, 0, 2, 1], dtype=torch.int32)
    values = torch.tensor([-1, 1, -(2**31), 2**31 - 1, 1, 1], dtype=torch.int32)
    got = encode.dict_codes_device(values, staged, code_of_rank, n=4)
    assert got.tolist() == [1, 3, 2, 0, 0, 0]
    with pytest.raises(ValueError, match="empty dictionary"):
        encode.dict_codes_device(values, staged[:0], code_of_rank[:0])


def test_rle_run_counts_device():
    v = np.concatenate([np.repeat(np.arange(8, dtype=np.int32), GROUP // 8), np.full(GROUP, 3, np.int32)])
    assert encode.rle_run_counts_device(_tensor(v)).tolist() == [8, 1]


def test_encoders_reject_what_the_kernel_does_not_take():
    rows = torch.zeros((2, GROUP), dtype=torch.int32)
    for bad in (0, 33, 9.0):
        with pytest.raises(ValueError, match="bits"):
            encode.lmp_pack(rows, bad)
    with pytest.raises(ValueError, match="prologue"):
        encode.lmp_pack(rows, 9, "rle")
    with pytest.raises(ValueError, match="frame_len"):
        encode.lmp_pack(rows, 9, "for_sub", refs=torch.zeros(1, dtype=torch.int32), frame_len=GROUP + 1)
    with pytest.raises(ValueError, match="needs refs"):
        encode.lmp_pack(rows, 9, "for_sub")
    with pytest.raises(ValueError, match="refs must have shape"):
        encode.lmp_pack(rows, 9, "for_sub", refs=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        encode.lmp_pack(rows.to(torch.int64), 9)
    with pytest.raises(ValueError, match="shape"):
        encode.lmp_pack(torch.zeros((2, GROUP - 1), dtype=torch.int32), 9)
    with pytest.raises(ValueError, match="whole GROUPs"):
        encode.nbit_pack_device(torch.zeros(GROUP + 1, dtype=torch.int32), 9)
    with pytest.raises(ValueError, match="whole frames"):  # 3 groups are not whole frames of 2
        encode.for_streams_device(torch.zeros(3 * GROUP, dtype=torch.int32), 9, 2 * GROUP)
    with pytest.raises(ValueError, match="no device encoder"):
        encode.encode_nbit_device(np.zeros(3, np.int32), bits=2, device="meta")


def test_uint32_tensors_are_taken_as_their_bits():
    u = _uint(32, GROUP, "uint32 view")
    got = encode.nbit_pack_device(torch.from_numpy(u), 32)
    assert _u32(got).tobytes() == ref_lmp.lmp_pack(u, 32).tobytes()


def test_encode_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there (tests/test_torch_cuda.py)")
    v = np.arange(10, dtype=np.int32)
    for fn, opts in ((encode.encode_nbit_device, {"bits": 4}), (encode.encode_rle_device, {}),
                     (encode.encode_dict_device, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(v, **opts)
