"""Per-frame model (linear / quadratic) — host codec (FORMAT.md §1.7).

The port's copy of giddy_tpu/ref/model.py. A per-frame model predicts the
values and the stream stores the zigzagged residuals. The encoder fits the
endpoint linear model and an integer quadratic (least-squares curvature,
then the same endpoint slope and unsigned-min intercept) per frame and
keeps whichever needs the narrower residual. If any frame keeps a
curvature term, the column ships as ``kind="poly2"`` with a third
coefficient stream (zero for the frames where linear won); otherwise as
``kind="linear"`` without ``coef_c``. Coefficients are integers and all
arithmetic wraps mod 2^32, so decode is bit-exact. The float64 fits use the
reference's NumPy calls in the reference's order, so the coefficients come
out byte-identical.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, bits_needed, cdiv, dtype_to_u32, pad_to_groups, u32_to_dtype, unzigzag, zigzag
from .lmp import lmp_pack, lmp_unpack


def _fit_slope(base: np.ndarray, d: np.ndarray, pos: np.ndarray):
    """Endpoint-slope fit for one reading ``d`` of each frame's wrapped
    first-to-last difference: slope + unsigned-min intercept, residual
    zigzags. All arithmetic wraps in uint32."""
    frame_len = base.shape[1]
    b64 = np.round(d / (frame_len - 1)).astype(np.int64)
    coef_b = b64.astype(np.uint32).view(np.int32)
    slope = coef_b.view(np.uint32)[:, None] * pos  # wraps like (i*b) & 0xFFFFFFFF
    resid0 = base - slope  # uint32 wrap == (frame - pred(a=0)) mod 2^32
    coef_a = resid0.min(axis=1).view(np.int32)
    pred = coef_a.view(np.uint32)[:, None] + slope
    resid = (base - pred).view(np.int32)
    return coef_a, coef_b, zigzag(resid)


def _fit(frames: np.ndarray, c: np.ndarray):
    """Given per-frame curvature ``c`` (int64, 0 = linear), the endpoint
    slope + unsigned-min intercept with the curvature term subtracted
    first, so c = 0 is the plain linear fit. Returns (coef_a, coef_b, zig),
    zig per padded element, uint32."""
    nf, frame_len = frames.shape
    pos = np.arange(frame_len, dtype=np.uint32)
    curve = (c.astype(np.uint32)[:, None] * (pos * pos)) if c.any() else 0
    base = frames - curve  # uint32 wrap
    # The wrapped first-to-last difference has two readings: signed
    # (recentered into [-2^31, 2^31), right for descending frames) and
    # unsigned (right for ascending frames whose span exceeds 2^31). Both
    # decode losslessly; keep the narrower residual per frame, signed on
    # ties, so frames of span < 2^31 (the readings agree) take one fit.
    d = base[:, -1].astype(np.int64) - base[:, 0].astype(np.int64)
    ds = ((d + 2**31) % 2**32) - 2**31
    du = d % 2**32
    a_s, b_s, z_s = _fit_slope(base, ds, pos)
    if np.array_equal(ds, du):
        return a_s, b_s, z_s
    a_u, b_u, z_u = _fit_slope(base, du, pos)
    use_u = z_u.max(axis=1) < z_s.max(axis=1)
    return (
        np.where(use_u, a_u, a_s).astype(np.int32),
        np.where(use_u, b_u, b_s).astype(np.int32),
        np.where(use_u[:, None], z_u, z_s),
    )


def _extrapolate_tail(frames: np.ndarray, re: int, try_quad: bool) -> None:
    """Replace the last frame's pad region with the model's own
    extrapolation, fitted on the real prefix [0, re). Pads decode to
    don't-care values, so any fill is lossless; an on-model fill keeps
    their residuals (which ship in the stream) near 0."""
    fl = frames.shape[1]
    if re >= fl or re < 2:
        return
    t = frames[-1]
    c = 0
    if try_quad and re >= 3:
        pos = np.arange(re, dtype=np.float64)
        X = np.stack([np.ones(re), pos, pos * pos])
        c = int(np.round((np.linalg.pinv(X.T)[2] * t[:re].astype(np.float64)).sum()))
    d = int(t[re - 1]) - int(t[0]) - c * (re - 1) * (re - 1)
    d = ((d + 2**31) % 2**32) - 2**31
    b = round(d / (re - 1))
    a = int(t[0])
    q = np.arange(re, fl, dtype=np.int64)
    t[re:] = ((a + b * q + c * q * q) & 0xFFFFFFFF).astype(np.uint32)


def encode(
    values: np.ndarray,
    *,
    bits: int | None = None,
    frame_len: int = GROUP,
    kind: str = "auto",
    name: str = "col",
) -> EncodedColumn:
    if frame_len % GROUP:
        raise ValueError(f"frame_len must be a multiple of GROUP={GROUP}")
    if kind not in ("auto", "linear", "poly2"):
        raise ValueError(f"kind must be auto|linear|poly2, got {kind!r}")
    values = np.asarray(values)
    n = values.shape[0]
    u32 = dtype_to_u32(values)
    # Pad with the last value: a zero tail would wreck the last frame's
    # linear fit (endpoint slope through 0) and force 32-bit residuals.
    fill = int(u32[-1]) if n else 0
    u = pad_to_groups(u32, fill=fill)
    n_pad = u.shape[0]
    nf = cdiv(n_pad, frame_len)
    upad = np.full(nf * frame_len, fill, dtype=np.uint32)
    upad[:n_pad] = u
    frames = upad.reshape(nf, frame_len)
    if n:
        _extrapolate_tail(frames, n - (nf - 1) * frame_len, kind != "linear")
    # Per-frame selection: linear always; quadratic where it narrows the
    # frame's residual. Frames are always full (padded), so frame_len >= 2.
    zero_c = np.zeros(nf, np.int64)
    a_lin, b_lin, z_lin = _fit(frames, zero_c)
    coef_a, coef_b, z = a_lin, b_lin, z_lin
    coef_c = None
    if kind != "linear" and frame_len >= 3:
        # least-squares quadratic coefficient per frame on the float64
        # lift, rounded to an integer so decode wraps exactly
        posf = np.arange(frame_len, dtype=np.float64)
        X = np.stack([np.ones(frame_len), posf, posf * posf])
        pinv = np.linalg.pinv(X.T)  # (3, frame_len)
        c64 = np.round(frames.astype(np.float64) @ pinv[2]).astype(np.int64)
        a_q, b_q, z_q = _fit(frames, c64)
        # keep the quadratic only where it strictly narrows the frame
        wl = np.array([bits_needed(int(m)) for m in z_lin.max(axis=1, initial=0)])
        wq = np.array([bits_needed(int(m)) for m in z_q.max(axis=1, initial=0)])
        use_q = (wq < wl) & (c64 != 0)
        if kind == "poly2" or use_q.any():
            c_sel = np.where(use_q, c64, 0)
            coef_a = np.where(use_q, a_q, a_lin).astype(np.int32)
            coef_b = np.where(use_q, b_q, b_lin).astype(np.int32)
            coef_c = c_sel.astype(np.uint32).view(np.int32)
            z = np.where(use_q[:, None], z_q, z_lin)
    z = z.reshape(-1)[:n_pad]
    if bits is None:
        bits = bits_needed(int(z.max(initial=0)))
    params = {"bits": int(bits), "frame_len": int(frame_len),
              "kind": "linear" if coef_c is None else "poly2"}
    streams = {"packed": lmp_pack(z, bits), "coef_a": coef_a, "coef_b": coef_b}
    if coef_c is not None:
        streams["coef_c"] = coef_c
    return EncodedColumn(
        name=name, scheme="model", dtype=str(values.dtype), n=n,
        params=params, streams=streams,
    )


def decode(col: EncodedColumn) -> np.ndarray:
    bits, frame_len = col.params["bits"], col.params["frame_len"]
    z = lmp_unpack(col.streams["packed"], bits, col.n)
    resid = unzigzag(z).astype(np.int64)
    a = col.streams["coef_a"].astype(np.int64)
    b = col.streams["coef_b"].astype(np.int64)
    j = np.arange(col.n, dtype=np.int64)
    f = j // frame_len
    p = j % frame_len
    pred = a[f] + b[f] * p
    if col.params.get("kind") == "poly2":
        c = col.streams["coef_c"].astype(np.int64)
        pred = pred + c[f] * (p * p)
    u = ((pred + resid) & 0xFFFFFFFF).astype(np.uint32)
    return u32_to_dtype(u, col.dtype)


registry.register("model", encode, decode)
