"""Plain PyTorch versions of the decode kernels (csrc/lmp_decode.cu K1-K4,
csrc/run_decode.cu K5-K8, csrc/patch_decode.cu K9, csrc/epilogue_decode.cu
K10-K12, csrc/dzbv_decode.cu K13-K15), with the fused
dictionary stage of cascade (``lut``) where the kernel has one, and of the
scan epilogue (csrc/scan_epilogue.cu K16, K17, K19), whose slot math the
scan layer's general path also runs on decoded values, and of device encode's
pack (csrc/encode.cu K18).

The counterpart of Pallas interpret mode: the same arithmetic in torch
ops, at the same signatures as the kernel wrappers. The wrappers take them
for CPU tensors only; ``chip_smoke.py`` also runs them on the card to hold
each kernel against them.

Payloads ride as int32 tensors carrying the uint32 bits: torch on the CPU
lacks most uint32 arithmetic. So a logical right shift masks off the sign
extension, and the wrapping cumsum runs in int64 and is cut back to 32 bits.
"""

from __future__ import annotations

import torch

from ..util import GROUP, LANES, SLOTS


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-carried uint32 bits."""
    return x if s == 0 else (x >> s) & ((1 << (32 - s)) - 1)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (mod 2^32)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def unpack_lanes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """LMP unpack: (ng, bits*LANES) words -> (ng, GROUP) values, in linear
    order (position i*LANES + c is slot i of lane c, FORMAT.md §0.1)."""
    ng = packed.shape[0]
    words = packed.reshape(ng, bits, LANES)
    out = torch.empty((ng, SLOTS, LANES), dtype=torch.int32, device=packed.device)
    for i in range(SLOTS):
        w0, s = divmod(i * bits, 32)
        v = _srl(words[:, w0], s)
        if s + bits > 32:
            v = v | (words[:, w0 + 1] << (32 - s))
        out[:, i] = v if bits == 32 else v & ((1 << bits) - 1)
    return out.reshape(ng, GROUP)


def unzigzag(z: torch.Tensor) -> torch.Tensor:
    """Unsigned zigzag -> signed int32 (FORMAT.md §0.2)."""
    return _srl(z, 1) ^ -(z & 1)


def group_cumsum(d: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along each (ng, GROUP) row plus base[g], mod 2^32."""
    return wrap32(torch.cumsum(d.to(torch.int64), dim=1) + base.to(torch.int64)[:, None])


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with the codes read as unsigned and clamped to the table,
    as the kernel does."""
    i = idx.to(torch.int64) & 0xFFFFFFFF
    return table[i.clamp_(max=table.shape[0] - 1)]


def lookup(x: torch.Tensor, lut: torch.Tensor | None) -> torch.Tensor:
    """The LUT stage of cascade decode: lut[x] (clamped), or x without a table."""
    return x if lut is None else gather(lut, x)


def lmp_unpack(packed: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    return lookup(unpack_lanes(packed, bits), lut).to(out_dtype)


def for_unpack(packed: torch.Tensor, refs_g: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    return lookup(unpack_lanes(packed, bits) + refs_g[:, None], lut).to(out_dtype)


def delta_decode(packed: torch.Tensor, anchors: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    return lookup(group_cumsum(unzigzag(unpack_lanes(packed, bits)), anchors), lut).to(out_dtype)


def dict_decode(codes: torch.Tensor, values: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return lmp_unpack(codes, bits, out_dtype, values)


def run_expand(ends_w: torch.Tensor, vals_w: torch.Tensor, ng: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    """Tile-form run tables (rows, w_pad) -> (ng, GROUP): at tile position
    j, the value of run #{ends <= j}, clamped to the table."""
    rows, w_pad = ends_w.shape
    width = ng * GROUP // rows
    j = torch.arange(width, dtype=torch.int32, device=ends_w.device).expand(rows, width).contiguous()
    r = torch.searchsorted(ends_w, j, right=True).clamp_(max=w_pad - 1)
    return lookup(torch.gather(vals_w, 1, r).reshape(ng, GROUP), lut).to(out_dtype)


def cumsum_rows(x: torch.Tensor, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    return lookup(group_cumsum(x, torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)), lut).to(out_dtype)


def delta2_decode(packed: torch.Tensor, anchors: torch.Tensor, slopes: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32, lut: torch.Tensor | None = None) -> torch.Tensor:
    # |s| < 2^31 and GROUP = 2^15, so both cumsums are exact in int64
    s = unzigzag(unpack_lanes(packed, bits)).to(torch.int64)
    cc = torch.cumsum(torch.cumsum(s, dim=1), dim=1)
    pos1 = torch.arange(1, GROUP + 1, dtype=torch.int64, device=packed.device)
    v = anchors.to(torch.int64)[:, None] + slopes.to(torch.int64)[:, None] * pos1 + cc
    return lookup(wrap32(v), lut).to(out_dtype)


def xordelta_decode(packed: torch.Tensor, anchors: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-group inclusive prefix XOR, XOR the anchor. torch has no
    cumulative XOR: 15 log steps x ^= x shifted by 2^k along the row."""
    x = unpack_lanes(packed, bits)
    shift = 1
    while shift < GROUP:
        y = x.clone()
        y[:, shift:] ^= x[:, :-shift]
        x, shift = y, 2 * shift
    return x ^ anchors[:, None]


def patched_decode(packed: torch.Tensor, refs_g: torch.Tensor | None, pos: torch.Tensor, val: torch.Tensor, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Base unpack (+ refs_g[g] for a FOR base), then out[pos] = val."""
    u = unpack_lanes(packed, bits)
    if refs_g is not None:
        u = u + refs_g[:, None]
    u.view(-1)[pos.to(torch.int64)] = val
    return u.to(out_dtype)


def model_decode(packed: torch.Tensor, a_g: torch.Tensor, b_g: torch.Tensor, c_g: torch.Tensor | None, bits: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """a_g[g] + b_g[g]·p (+ c_g[g]·p²) + unzigzag(residual), p the position
    within the group, computed in int64 and cut to 32 bits."""
    # |c·p²| < 2^61 and |b·p| < 2^46: exact in int64, and mod 2^32 the
    # coefficients' sign does not matter
    p = torch.arange(GROUP, dtype=torch.int64, device=packed.device)
    pred = a_g.to(torch.int64)[:, None] + b_g.to(torch.int64)[:, None] * p
    if c_g is not None:
        pred = pred + c_g.to(torch.int64)[:, None] * (p * p)
    return wrap32(pred + unzigzag(unpack_lanes(packed, bits))).to(out_dtype)


def bitmap_decode(bitmaps: torch.Tensor, values: torch.Tensor, ng: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Σ over the d LMP(1) planes of bit · values[d] (a sum, not a select),
    in int64 and cut to 32 bits."""
    acc = torch.zeros((ng, GROUP), dtype=torch.int64, device=bitmaps.device)
    for dd in range(values.shape[0]):
        acc += unpack_lanes(bitmaps[dd].view(ng, LANES), 1) * values[dd].to(torch.int64)
    return wrap32(acc).to(out_dtype)


def alp_decode(packed: torch.Tensor, corr: torch.Tensor, refs_g: torch.Tensor, patch_pos: torch.Tensor, patch_val: torch.Tensor, bits: int, corr_bits: int, scale_bits: int, count: int) -> torch.Tensor:
    """bits(f32(unpack + refs_g[g]) × f32(10^-e)) + unzigzag(corr), then
    out[patch_pos] = patch_val; ``scale_bits`` is f32(10^-e) as its bits."""
    enc = wrap32(unpack_lanes(packed, bits).to(torch.int64) + refs_g.to(torch.int64)[:, None])
    scale = wrap32(torch.tensor(scale_bits, dtype=torch.int64, device=packed.device)).view(torch.float32)
    m = (enc.to(torch.float32) * scale).view(torch.int32)
    out = wrap32(m.to(torch.int64) + unzigzag(unpack_lanes(corr, corr_bits)))
    if count:
        out.view(-1)[patch_pos.to(torch.int64)] = patch_val
    return out


def _dzbv_byte_or(out: torch.Tensor, mask: torch.Tensor, byte: torch.Tensor, k: int) -> torch.Tensor:
    """out | byte << 8k where mask (the values wider than k bytes)."""
    return out | (torch.where(mask, byte, 0) << (8 * k))


def _exclusive_rank(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Exclusive count of the set mask entries before each, along dim (int64)."""
    m = mask.to(torch.int64)
    return torch.cumsum(m, dim=dim) - m


def _t8_bytes(trow: torch.Tensor) -> torch.Tensor:
    """(ng, 64*s) T8-packed words -> (ng, 256*s) bytes in tile-compacted
    order: byte q at word (q // 512) * 128 + q % 128, bits 8 * (q // 128 % 4)."""
    ng, width = trow.shape
    words = trow.view(ng, width // 128, 1, 128)
    return torch.cat([_srl(words, 8 * j) & 0xFF for j in range(4)], dim=2).reshape(ng, 4 * width)


def dzbv_tile_decode(widths: torch.Tensor, plane0: torch.Tensor, trows: tuple, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plane 0, then for each plane k present the byte at q = t*s_k + (rank
    of the value among the values of its 128-value tile t with w > k) of the
    group's trow row (q clamped to the row)."""
    codes, out = unpack_lanes(widths, 2), unpack_lanes(plane0, 8)
    ng = codes.shape[0]
    tile = torch.arange(GROUP, dtype=torch.int64, device=widths.device) >> 7
    for k, trow in enumerate(trows, 1):
        if trow is None:
            continue
        s = trow.shape[1] // 64
        mask = codes >= k
        rank = _exclusive_rank(mask.view(ng, GROUP // 128, 128), 2).view(ng, GROUP)
        q = (tile * s + rank).clamp_(max=256 * s - 1)
        out = _dzbv_byte_or(out, mask, torch.gather(_t8_bytes(trow), 1, q), k)
    return out.to(out_dtype)


def dzbv_group_decode(widths: torch.Tensor, plane0: torch.Tensor, prows: tuple, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plane 0, then for each plane k present byte m = (rank of the value
    among its group's values with w > k) of the group's prow row, LMP(8) of
    w4_k * 1024 words (zero past them)."""
    codes, out = unpack_lanes(widths, 2), unpack_lanes(plane0, 8)
    for k, prow in enumerate(prows, 1):
        if prow is None:
            continue
        mask = codes >= k
        full = torch.nn.functional.pad(prow, (0, 8 * LANES - prow.shape[1]))
        byte = torch.gather(unpack_lanes(full, 8), 1, _exclusive_rank(mask, 1))
        out = _dzbv_byte_or(out, mask, byte, k)
    return out.to(out_dtype)


def dzbv_plane_decode(widths: torch.Tensor, plane0: torch.Tensor, planes: tuple, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plane 0, then for each plane k present byte r = (rank of the value
    among all the column's values with w > k) of plane k (r clamped to the
    plane): the reference's global cumsum and take."""
    codes, out = unpack_lanes(widths, 2), unpack_lanes(plane0, 8)
    for k, plane in enumerate(planes, 1):
        if plane is None:
            continue
        mask = codes >= k
        flat = unpack_lanes(plane, 8).reshape(-1)
        r = _exclusive_rank(mask.reshape(-1), 0).clamp_(max=flat.shape[0] - 1)
        out = _dzbv_byte_or(out, mask, flat[r].view(mask.shape), k)
    return out.to(out_dtype)


# -- the scan epilogue: K16 filter_fold, K17 agg_fold, K19 run_filter ----------

CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge}


def order_key(u: torch.Tensor, kind: str, itemsize: int) -> torch.Tensor:
    """uint32 payloads -> int32 keys whose signed order is the logical
    dtype's (giddy_tpu/aggregate.py:33-52 ``_key_map_traced``): narrow
    signed payloads sign-extended, unsigned ones with the sign bit flipped,
    floats in IEEE total order (-NaN < -inf < ... < -0.0 < +0.0 < ... < +NaN,
    query.py:42-48) re-biased to signed. A bijection, so eq/ne and every
    order compare of query.py's ``_cmp`` hold on the keys."""
    if kind == "i":
        k = 32 - 8 * itemsize
        return (u << k) >> k if k else u
    if kind == "f":
        return u ^ ((u >> 31) & 0x7FFFFFFF)
    return u ^ -(2**31)


def pack_hits(hits: torch.Tensor) -> torch.Tensor:
    """(ng, GROUP) bool -> (ng, LANES) LMP(1) words: bit i of word [g, c] is
    hits[g, i*LANES + c]. The bits are distinct, so the sum is their OR."""
    ng = hits.shape[0]
    shifts = torch.arange(SLOTS, dtype=torch.int32, device=hits.device)[:, None]
    return (hits.view(ng, SLOTS, LANES).to(torch.int32) << shifts).sum(1, dtype=torch.int32)


def filter_fold(packed: torch.Tensor, refs_g: torch.Tensor | None, valid: torch.Tensor | None, bits: int, kind: str, itemsize: int, op: str, key: int) -> torch.Tensor:
    """Unpack (+ refs_g[g]), compare each value's order key with ``key`` (the
    staged comparison value, already a key) -> (ng, LANES) LMP(1) words,
    ANDed with the validity words when given. Pad bits are whatever the
    compare gives."""
    u = unpack_lanes(packed, bits)
    if refs_g is not None:
        u = u + refs_g[:, None]
    words = pack_hits(CMP[op](order_key(u, kind, itemsize), key))
    return words if valid is None else words & valid


def run_filter(ends_w: torch.Tensor, vals_w: torch.Tensor, valid: torch.Tensor | None, ng: int, kind: str, itemsize: int, op: str, key: int) -> torch.Tensor:
    """Tile-form run tables (rows, w_pad) -> (ng, LANES) LMP(1) words of the
    predicate (K19): each entry's value compared once, each position taking
    its run's hit by :func:`run_expand`'s rule (pad positions too), ANDed
    with the validity words when given."""
    hits = CMP[op](order_key(vals_w, kind, itemsize), key).to(torch.int32)
    words = pack_hits(run_expand(ends_w, hits, ng).bool())
    return words if valid is None else words & valid


def slot_fold(u: torch.Tensor, valid: torch.Tensor | None, n: int, kind: str, itemsize: int, agg: str) -> tuple:
    """The per-(group, lane) partials of giddy_tpu/aggregate.py:70-101
    ``_slot_fold`` over (ng, GROUP) payloads: values at positions >= n (and,
    for the sum, rows whose validity bit is 0) drop out. 'sum' -> (lo, hi,
    neg): the lane's unsigned sum mod 2^32, its carries out, and its count
    of sign bits (signed kinds); 'min'/'max' -> (key,) of :func:`order_key`,
    INT_MAX / INT_MIN where no value took part. All (ng, LANES) int32."""
    ng = u.shape[0]
    live = torch.arange(ng * GROUP, device=u.device).view(ng, GROUP) < n
    if agg == "sum":
        if valid is not None:
            live &= unpack_lanes(valid, 1).bool()
        v = torch.where(live, u.to(torch.int64) & 0xFFFFFFFF, 0).view(ng, SLOTS, LANES)
        s = v.sum(1)  # < 32 * 2^32: the carries are s >> 32
        if kind == "i":
            neg = ((v >> (8 * itemsize - 1)) & 1).sum(1).to(torch.int32)
        else:
            neg = torch.zeros((ng, LANES), dtype=torch.int32, device=u.device)
        return wrap32(s), (s >> 32).to(torch.int32), neg
    init = -(2**31) if agg == "max" else 2**31 - 1
    keys = torch.where(live, order_key(u, kind, itemsize), init).view(ng, SLOTS, LANES)
    return (keys.amax(1) if agg == "max" else keys.amin(1),)


def agg_fold(packed: torch.Tensor, refs_g: torch.Tensor | None, valid: torch.Tensor | None, bits: int, n: int, kind: str, itemsize: int, agg: str) -> tuple:
    """Unpack (+ refs_g[g]), then :func:`slot_fold`."""
    u = unpack_lanes(packed, bits)
    if refs_g is not None:
        u = u + refs_g[:, None]
    return slot_fold(u, valid, n, kind, itemsize, agg)


# -- device encode: K18 lmp_pack ---------------------------------------------


def pack_lanes(v: torch.Tensor, bits: int) -> torch.Tensor:
    """LMP pack, the inverse of :func:`unpack_lanes`: (ng, GROUP) values ->
    (ng, bits*LANES) words, slot i ORed in at (w0, s) = divmod(i*bits, 32)
    (giddy_tpu/kernels/encode.py:28-42). Values are not masked to ``bits``,
    as in the reference: an out-of-range value spills the same way."""
    ng = v.shape[0]
    slots = v.reshape(ng, SLOTS, LANES)
    words = torch.zeros((ng, bits, LANES), dtype=torch.int32, device=v.device)
    for i in range(SLOTS):
        w0, s = divmod(i * bits, 32)
        words[:, w0] |= slots[:, i] << s
        if s + bits > 32:
            words[:, w0 + 1] |= _srl(slots[:, i], 32 - s)
    return words.reshape(ng, bits * LANES)


def zigzag(d: torch.Tensor) -> torch.Tensor:
    """Signed int32 -> unsigned zigzag bits (FORMAT.md §0.2). ``d >> 31`` is
    the arithmetic shift here (0 or -1), so it takes the place of the
    reference's ``-(d >> 31)`` on uint32."""
    return (d << 1) ^ (d >> 31)


def lmp_pack(values: torch.Tensor, bits: int, prologue: str = "none", refs: torch.Tensor | None = None, n: int | None = None, frame_len: int = GROUP) -> torch.Tensor:
    """The value transform, then :func:`pack_lanes`: ``for_sub`` subtracts
    refs[g // (frame_len // GROUP)] from group g (mod 2^32);
    ``delta_zigzag`` packs zigzag(v[j] - v[j-1]), 0 at j == 0 and j >= n
    (giddy_tpu/kernels/encode.py:77-90, :104-109)."""
    ng = values.shape[0]
    v = values
    if prologue == "for_sub":
        g = torch.arange(ng, device=values.device) // (frame_len // GROUP)
        v = v - refs[g][:, None]
    elif prologue == "delta_zigzag":
        flat = v.reshape(-1)
        j = torch.arange(flat.shape[0], device=values.device)
        n = flat.shape[0] if n is None else n
        d = torch.where((j == 0) | (j >= n), 0, flat - torch.roll(flat, 1))
        v = zigzag(d).reshape(ng, GROUP)
    return pack_lanes(v, bits)
