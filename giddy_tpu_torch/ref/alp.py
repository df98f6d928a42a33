"""ALP-style lossless decimal-float compression — host codec (FORMAT.md §1.16).

The port's copy of giddy_tpu/ref/alp.py. A float32 column of decimals
(prices, rates) is stored as integers ``enc = rint(v * 10^e)`` for one
column exponent e in [0, E_MAX], FOR-style (per-GROUP refs + LMP offsets),
plus a per-value ulp correction ``corr = bits(v) - bits(m)`` where
``m = f32(enc) * f32(10^-e)``. The int -> f32 convert and the f32 multiply
are single correctly rounded IEEE operations, so the host and the card give
the same m, and decode is ``bits(m) + corr`` in integer wrap arithmetic.
Whatever fails (NaN/Inf, |enc| >= 2^23, subnormals, -0.0, corrections past
the covered width) is an exception: position + original bit pattern,
written over the decoded values as in patched (FORMAT.md §1.11).
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, bits_needed, num_groups, pad_to_groups, unzigzag, zigzag
from .lmp import lmp_pack, lmp_unpack

E_MAX = 10  # 10^10 is exactly representable in f32; enc < 2^23 binds first
CORR_COVER = 0.995  # corr width covers this fraction; the tail is patched
CORR_MAX = 24  # widest useful correction: past this, patch the value
# Above this many groups, the exponent search runs on an evenly strided
# group sample; the full column still gets one exact analysis with the
# winner, and exceptions keep every choice lossless.
SAMPLE_GROUPS = 16


def scale_bits(e: int) -> int:
    """The uint32 bit pattern of f32(10^-e), the decode's multiplier, as
    :func:`_approx_bits` rounds it (the device takes it as bits)."""
    return int(np.float32(10.0**-e).view(np.uint32))


def _approx_bits(enc: np.ndarray, e: int) -> np.ndarray:
    """int32 bitpatterns of the device-reproducible approximation
    ``f32(enc) * f32(10^-e)`` (both ops single-rounded IEEE f32)."""
    m = enc.astype(np.float32) * np.float32(10.0**-e)
    return m.view(np.int32)


def _analyze(v: np.ndarray, e: int):
    """(enc int64, zig uint32, ok_range bool) for exponent ``e``."""
    with np.errstate(invalid="ignore", over="ignore"):
        encf = np.rint(v.astype(np.float64) * 10.0**e)
        # range-check the float before any int cast: casting huge finite
        # floats to int64 is undefined in C and differs across machines
        ok = np.isfinite(encf) & (np.abs(encf) < 2**23)
        enc = np.where(ok, encf, 0.0).astype(np.int64)
    u = v.view(np.uint32)
    # a subnormal v is always an exception: flush-to-zero units disagree
    # with the host there
    subnormal = ((u & 0x7F800000) == 0) & ((u & 0x007FFFFF) != 0)
    ok &= ~subnormal
    corr = np.where(ok, u.view(np.int32) - _approx_bits(enc.astype(np.int32), e), 0)
    return enc, zigzag(corr.astype(np.int32)), ok


def _candidate(v: np.ndarray, n_eff: int, cand: int):
    """Full analysis of exponent ``cand`` over a group-padded array ``v``
    (n_eff = un-padded element count, for the exception-cost term).
    Returns (cost, cand, ok, offs, refs, bits, zig, corr_bits)."""
    ng = v.shape[0] // GROUP
    enc, zig, okr = _analyze(v, cand)
    # correction width: cover CORR_COVER of the coverable in-range values;
    # corrections of CORR_MAX bits or more (-0.0's 2^32-1, sign flips) are
    # left out of the quantile and become exceptions
    cov = okr & (zig < np.uint32(1) << np.uint32(CORR_MAX))
    zr = zig[cov] if cov.any() else np.zeros(1, np.uint32)
    q = int(np.quantile(zr.astype(np.float64), CORR_COVER, method="lower"))
    corr_bits = min(bits_needed(q), CORR_MAX)
    ok = okr & (zig.astype(np.int64) < (1 << corr_bits))
    ex = int((~ok[:n_eff]).sum())
    # benign stand-in for exceptions: the group's min of ok values (keeps
    # offsets narrow); all-exception groups fall back to 0
    gmin = np.where(ok, enc, np.int64(2**62)).reshape(ng, GROUP).min(axis=1)
    gmin = np.where(gmin == 2**62, 0, gmin)
    encf = np.where(ok, enc, np.repeat(gmin, GROUP))
    refs = encf.reshape(ng, GROUP).min(axis=1)
    offs = (encf - np.repeat(refs, GROUP)).astype(np.uint32)
    bits = bits_needed(int(offs.max(initial=0)))
    cost = ng * GROUP * (bits + corr_bits) / 8 + ex * 8 + ng * 4
    return (cost, cand, ok, offs, refs, bits, np.where(ok, zig, 0), corr_bits)


def encode(
    values: np.ndarray,
    *,
    e: int | None = None,
    name: str = "col",
) -> EncodedColumn:
    values = np.asarray(values)
    if values.dtype != np.float32:
        raise ValueError(f"alp encodes float32 columns, got {values.dtype}")
    n = values.shape[0]
    u = values.view(np.uint32)
    fill = int(u[-1]) if n else 0  # last-value pad keeps group refs sane
    v = pad_to_groups(u, fill=fill).view(np.float32)
    ng = num_groups(n)

    if e is not None:
        cands = [e]
    elif ng > SAMPLE_GROUPS:
        idx = np.unique(np.linspace(0, ng - 1, SAMPLE_GROUPS).astype(np.int64))
        vs = v.reshape(ng, GROUP)[idx].reshape(-1)
        # the sample always holds the tail group, whose pad fill must not
        # count as real elements in the exception-cost term; the pads sit
        # at the end of the sample (idx ascending, last = ng-1)
        n_eff = vs.shape[0] - (ng * GROUP - n)
        scored = [_candidate(vs, n_eff, c)[:2] for c in range(E_MAX + 1)]
        cands = [min(scored)[1]]
    else:
        cands = range(E_MAX + 1)
    best = min(_candidate(v, n, cand) for cand in cands)
    _, exp_e, ok, offs, refs, bits, zig, corr_bits = best
    pos = np.nonzero(~ok[:n])[0].astype(np.int32)
    patch_val = u[pos.astype(np.int64)].view(np.int32)
    return EncodedColumn(
        name=name,
        scheme="alp",
        dtype="float32",
        n=n,
        params={
            "bits": int(bits),
            "corr_bits": int(corr_bits),
            "exp_e": int(exp_e),
            "count": int(pos.shape[0]),
        },
        streams={
            "packed": lmp_pack(offs, bits),
            "corr": lmp_pack(zig.astype(np.uint32), corr_bits),
            "refs": refs.astype(np.uint32).astype(np.int32),
            "patch_pos": pos,
            "patch_val": patch_val,
        },
    )


def decode(col: EncodedColumn) -> np.ndarray:
    p = col.params
    offs = lmp_unpack(col.streams["packed"], p["bits"], col.n)
    zig = lmp_unpack(col.streams["corr"], p["corr_bits"], col.n)
    refs = col.streams["refs"].view(np.uint32)
    gidx = np.arange(col.n, dtype=np.int64) // GROUP
    enc = (refs[gidx] + offs).astype(np.uint32).view(np.int32)
    out = _approx_bits(enc, p["exp_e"]).view(np.uint32)
    out = (out + unzigzag(zig).view(np.uint32)).copy()  # wrap add
    pos = col.streams["patch_pos"].astype(np.int64)
    out[pos] = col.streams["patch_val"].view(np.uint32)
    return out.view(np.float32)


registry.register("alp", encode, decode)
