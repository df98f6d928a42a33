"""giddy_tpu_torch's alp scheme against giddy_tpu's, on the CPU: encode (the
exponent search, full and sampled), the host prep, and decode through K12's
plain version against the JAX decode (Pallas interpret mode), the NumPy
oracle and the input, on decimal prices, random floats and a column salted
with every kind of exception. Everything is compared bit for bit
(tolerance 0)."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu.kernels import alp as gt_alp
from giddy_tpu.ref import alp as gt_ref_alp
from giddy_tpu_torch import kernels
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.kernels import alp, lanes
from giddy_tpu_torch.ref import alp as ref_alp
from giddy_tpu_torch.util import GROUP

from test_torch_host import assert_same_column
from test_torch_inputs import rng_of, salted_prices

N = 2 * GROUP + 999  # three groups, the last one ragged


def salted(n: int, seed: str) -> np.ndarray:
    return salted_prices(n, rng_of(seed))


def _decode_both(ref, **kw):
    out = gtt.decode(gtt.from_reference(ref), device="cpu", **kw)
    return out, np.asarray(gt.decode(ref, **kw))


def check_all(v: np.ndarray, **opts) -> gtt.EncodedColumn:
    port, ref = gtt.encode(v, "alp", name="a", **opts), gt.encode(v, "alp", name="a", **opts)
    assert_same_column(port, ref)
    assert gtt.decode_ref(port).tobytes() == gt.decode_ref(ref).tobytes() == v.tobytes()
    got, want = _decode_both(ref, pad=True)
    assert got.shape == (max(1, -(-v.shape[0] // GROUP)) * GROUP,)
    assert got.numpy().tobytes() == want.tobytes()
    out = gtt.decode(port, device="cpu")
    assert out.dtype == torch.float32 and out.numpy().tobytes() == v.tobytes()
    return port


@pytest.mark.parametrize("n", [N, GROUP, 0])
@pytest.mark.parametrize("data", ["prices", "hard", "salted"])
def test_alp_matches_jax_oracle_and_input(data, n):
    v = salted(n, f"s{n}") if data == "salted" else gen_column("alp", n, rng_of(f"{data}{n}"), hard=data == "hard")
    col = check_all(v)
    if data == "prices" and n:
        assert col.params["exp_e"] == 2 and col.params["count"] == 0
    if data == "salted" and n:
        assert col.params["count"] > n // 100


@pytest.mark.parametrize("e", [0, 2, 10])  # at e = 2 the salt holds v·10^e at 2^23 - 1, 2^23, 2^23 + 1
@pytest.mark.parametrize("data", ["prices", "salted"])
def test_forced_exponent(data, e):
    v = salted(N, f"e{e}") if data == "salted" else gen_column("alp", N, rng_of(f"e{e}"))
    assert check_all(v, e=e).params["exp_e"] == e


def test_sampled_exponent_search_matches_reference():
    """Above SAMPLE_GROUPS groups the exponent is chosen on a group sample."""
    assert ref_alp.SAMPLE_GROUPS == gt_ref_alp.SAMPLE_GROUPS
    assert (ref_alp.E_MAX, ref_alp.CORR_COVER, ref_alp.CORR_MAX) == (
        gt_ref_alp.E_MAX, gt_ref_alp.CORR_COVER, gt_ref_alp.CORR_MAX)
    n = (ref_alp.SAMPLE_GROUPS + 1) * GROUP + 5
    v = salted(n, "sampled")
    assert_same_column(gtt.encode(v, "alp"), gt.encode(v, "alp"))


def test_scale_bits_are_the_encoders():
    for e in range(ref_alp.E_MAX + 1):
        want = np.float32(10.0**-e)
        assert ref_alp.scale_bits(e) == int(want.view(np.uint32))
        scale = torch.tensor(ref_alp.scale_bits(e), dtype=torch.int32).view(torch.float32)
        assert scale.item() == float(want)


def test_prep_matches_reference():
    v = salted(N, "prep")
    ref = gt.encode(v, "alp")
    want = gt_alp.prep(ref)
    got = alp.prep(gtt.from_reference(ref))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == (w.shape if k != "refs_g" else (w.shape[0],)), k  # (ng, 1) there, (ng,) here
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    col = gtt.from_reference(ref)
    col.streams = {k: np.asarray(w) for k, w in want.items()}
    assert alp.prep(col) is col.streams
    assert gtt.decode(col, device="cpu").numpy().tobytes() == v.tobytes()


def test_kernel_call_and_cpu_launches_nothing():
    v = salted(N, "call")
    col = gtt.encode(v, "alp")
    before = kernels.launches()
    name, args = kernels.kernel_call(col, gtt.device_streams(col, "cpu"), gtt.narrow_store_dtype(col))
    packed, corr, refs_g, pos, val, bits, corr_bits, scale_bits, count = args
    assert name == "alp_decode" and refs_g.shape == (3,) and pos.shape == val.shape == (count,)
    assert scale_bits == ref_alp.scale_bits(col.params["exp_e"]) and count == col.params["count"] > 0
    out = alp.alp_decode(*args)
    assert kernels.launches() == before
    assert torch.equal(out, lanes.alp_decode(*args))
    assert out.reshape(-1)[:N].numpy().tobytes() == v.view(np.int32).tobytes()


def _words(bits, ng=2):
    return torch.zeros((ng, bits * 1024), dtype=torch.int32)


def _i32(n):
    return torch.zeros(n, dtype=torch.int32)


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: alp.alp_decode(_words(4), _words(2, 3), _i32(2), _i32(0), _i32(0), 4, 2, 0, 0), ValueError),
        (lambda: alp.alp_decode(_words(4), _words(2), _i32(2), _i32(1), _i32(1), 4, 2, 0, 0), ValueError),
        (lambda: alp.alp_decode(_words(4), _words(2), _i32(2), _i32(1), _i32(2), 4, 2, 0, 1), ValueError),
        (lambda: alp.alp_decode(_words(4), _words(2), _i32(3), _i32(0), _i32(0), 4, 2, 0, 0), ValueError),
        (lambda: alp.alp_decode(_words(4), _words(2), _i32(2), _i32(0), _i32(0), 4, 3, 0, 0), ValueError),
        (lambda: alp.alp_decode(_words(4), _words(2), _i32(2), _i32(0), _i32(0), 4, 2, -1, 0), ValueError),
        (lambda: alp.alp_decode(_words(4), _words(2).to(torch.int64), _i32(2), _i32(0), _i32(0), 4, 2, 0, 0),
         TypeError),
    ],
)
def test_wrapper_rejects_bad_arguments(call, exc):
    with pytest.raises(exc):
        call()
