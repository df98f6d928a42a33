"""giddy_tpu_torch.advisor against giddy_tpu.advisor on the CPU: the same
numpy-seeded columns of every dtype get the same ranking (``measure=False``,
tolerance 0: same schemes in the same order, same ratios) and
``encode(v, "auto")`` writes the same container bytes, nullable columns and
n = 0 included. The trial encodes are host NumPy in both packages, so
nothing here traces JAX. ``measure=True`` is held to the reference's
tie-break rule with a stubbed timer (the real timer runs on the device)."""

import numpy as np
import pytest

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import advisor as jadv
from giddy_tpu_torch import advisor
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import rng_of

N = 2 * GROUP + 999
DTYPES = ["int32", "uint32", "float32", "int16", "uint16", "int8", "uint8", "int64", "uint64", "float64"]
SHAPES = ["random", "small", "runs", "sorted", "decimal"]


def column(dtype: str, shape: str, n: int = N) -> np.ndarray:
    """n values of ``dtype``: ``random`` over the dtype's range, ``small``
    in 0..99, ``runs`` 4 values in runs of ~300, ``sorted`` a slow ramp,
    ``decimal`` two-decimal prices (integers: multiples of 100)."""
    rng = rng_of(f"advisor/{dtype}/{shape}/{n}")
    dt = np.dtype(dtype)
    if shape == "random":
        if dt.kind == "f":
            return rng.normal(0, 1e3, n).astype(dt)
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    if shape == "small":
        v = rng.integers(0, 100, n)
    elif shape == "runs":
        v = np.repeat(rng.integers(0, 4, n // 300 + 1), 300)[:n]
    elif shape == "sorted":
        v = np.cumsum(rng.integers(0, 3, n)) // 7
    else:
        cents = rng.integers(0, 10_000, n)
        return (cents / 100.0).astype(dt) if dt.kind == "f" else (cents * 100 % 120).astype(dt)
    return v.astype(dt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_suggest_ranks_as_the_reference(dtype, shape):
    v = column(dtype, shape)
    want = jadv.suggest(v)
    got = advisor.suggest(v)
    assert got == want


def outcome(encode, container_bytes, v, **kw):
    """The container bytes of encode(v, "auto"), or the type and message
    of its refusal (64-bit columns that no 32-bit scheme takes fall back
    to raw, which refuses them in both packages)."""
    try:
        return container_bytes([encode(v, "auto", name="c", **kw)])
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_auto_writes_the_reference_bytes(dtype, shape):
    v = column(dtype, shape)
    assert outcome(gtt.encode, gtt.container_bytes, v) == outcome(gt.encode, gt.container_bytes, v)


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint16", "int64"])
def test_encode_auto_nullable_and_sampled(dtype):
    """A nullable column (the advisor sees the canonical fill) and one past
    sample_groups GROUPs (the sampled window comes from default_rng(0))."""
    v = column(dtype, "runs", 6 * GROUP + 5)
    valid = rng_of(f"advisor/valid/{dtype}").random(v.shape[0]) > 0.1
    for kw in ({}, {"valid": valid}):
        assert outcome(gtt.encode, gtt.container_bytes, v, **kw) == outcome(gt.encode, gt.container_bytes, v, **kw)
    assert advisor.suggest(v, sample_groups=2) == jadv.suggest(v, sample_groups=2)


@pytest.mark.parametrize("dtype", ["int32", "float32", "int8"])
def test_encode_auto_empty_column(dtype):
    v = np.zeros(0, np.dtype(dtype))
    assert advisor.suggest(v) == jadv.suggest(v)
    assert outcome(gtt.encode, gtt.container_bytes, v) == outcome(gt.encode, gt.container_bytes, v)


def test_candidates_and_encode_best_ranked():
    assert advisor.CANDIDATES == jadv.CANDIDATES
    v = column("int32", "sorted")
    ranked = advisor.suggest(v, candidates=["nbit", "for", "delta"])
    assert ranked == jadv.suggest(v, candidates=["nbit", "for", "delta"])
    col = advisor.encode_best(v, name="x", ranked=ranked)
    assert col.scheme == ranked[0][0]
    np.testing.assert_array_equal(gtt.decode_ref(col), v)
    # nothing beats 1.0x: raw
    assert advisor.encode_best(v, name="x", ranked=[]).scheme == "raw"


def test_measured_tiebreak_reorders_only_the_ties(monkeypatch):
    """measure=True re-orders the near-tied prefix by the timer's figures
    (stubbed here) and keeps every ratio with its scheme."""
    v = column("int32", "small", 4 * GROUP)
    plain = advisor.suggest(v)
    speeds = {s: float(i) for i, (s, _) in enumerate(plain)}  # reverse order
    calls = []

    def fake(sample, scheme, **kw):
        calls.append(scheme)
        return speeds[scheme]

    monkeypatch.setattr(advisor, "_measure_decode_gbps", fake)
    measured = advisor.suggest(v, measure=True, tie_tol=0.10, device="cpu")
    assert calls, "no candidates were measured"
    k = len(calls)
    assert [s for s, _ in measured[:k]] == sorted(calls, key=lambda s: -speeds[s])
    assert dict(measured) == dict(plain) and measured[k:] == plain[k:]


def test_measure_decode_gbps_on_cpu():
    v = rng_of("advisor/measure").integers(0, 64, GROUP).astype(np.int32)
    assert advisor._measure_decode_gbps(v, "nbit", iters=1, target_groups=1, device="cpu") > 0.0
    assert advisor._measure_decode_gbps(v, "nosuchscheme", device="cpu") == 0.0


def test_measure_on_a_missing_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the missing-card error cannot occur")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        advisor._measure_decode_gbps(column("int32", "small"), "nbit")
