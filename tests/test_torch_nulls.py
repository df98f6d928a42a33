"""giddy_tpu_torch.nulls and ``encode(..., valid=mask)`` against
giddy_tpu's on the CPU: the canonical fill, the validity stream and every
stream of a nullable column byte for byte, the decode of a nullable
column (its filled values), and the validity bitmaps, which compose with
the query.py bitmap algebra."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
import giddy_tpu_torch as gtt
from giddy_tpu import nulls as jnulls
from giddy_tpu_torch import nulls, query
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import rng_of, scan_values

N = 2 * GROUP + 999  # three groups, the last one ragged


def mask_of(kind: str, n: int = N) -> np.ndarray:
    """True = valid. 'some': 13% nulls, two of them leading; 'none': no
    nulls; 'all': every row null; 'one': one valid row."""
    if kind == "some":
        m = rng_of("mask").random(n) >= 0.13
        m[:2] = False
        return m
    if kind == "one":
        return np.arange(n) == n // 2
    return np.full(n, kind == "none")


@pytest.mark.parametrize("kind", ["some", "none", "all", "one"])
def test_fill_pack_and_counts_match_jax(kind):
    m = mask_of(kind)
    v = scan_values("int16", N, rng_of(f"fill/{kind}"))
    assert nulls.fill_nulls(v, m).tobytes() == jnulls.fill_nulls(v, m).tobytes()
    words = nulls.pack_valid(m)
    assert words.dtype == np.uint32 and words.tobytes() == jnulls.pack_valid(m).tobytes()
    assert np.array_equal(nulls.unpack_valid(words, N), m)
    col = gtt.encode(v, "nbit", valid=m)
    assert nulls.null_count(col) == int((~m).sum()) and nulls.count_valid(col) == int(m.sum())
    assert np.array_equal(nulls.valid_mask(col), m)
    assert np.array_equal(nulls.null_positions(col), np.flatnonzero(~m))


@pytest.mark.parametrize("scheme", ["nbit", "dzbf", "for", "delta", "dict", "rle", "rpe", "cascade", "patched"])
def test_encode_with_valid_matches_jax_streams(scheme):
    m = mask_of("some")
    v = scan_values("int32", N, rng_of(f"enc/{scheme}"))
    if scheme in ("dict", "cascade", "rle", "rpe"):
        v = v[rng_of(f"codes/{scheme}").integers(0, 40, N)]
    ref = gt.encode(v, scheme, valid=m)
    col = gtt.encode(v, scheme, valid=m)
    assert nulls.is_nullable(col) and col.params == ref.params
    assert sorted(col.streams) == sorted(ref.streams)
    for k in ref.streams:
        assert np.asarray(col.streams[k]).tobytes() == np.asarray(ref.streams[k]).tobytes(), k
    filled = gtt.decode(col, device="cpu")
    assert filled.numpy().tobytes() == nulls.fill_nulls(v, m).tobytes() == np.asarray(gt.decode(ref)).tobytes()
    values, valid = nulls.decode_masked(col, device="cpu")
    assert torch.equal(values, filled) and np.array_equal(valid.numpy(), m)


def test_bitmaps_and_scans_of_nullable_columns_match_jax():
    m = mask_of("some")
    v = scan_values("int32", N, rng_of("bitmaps"))
    ref, col = gt.encode(v, "for", valid=m), gtt.encode(v, "for", valid=m)
    plain_ref, plain = gt.encode(v, "for"), gtt.encode(v, "for")
    for c, r in ((col, ref), (plain, plain_ref)):
        assert nulls.notnull_bitmap(c, device="cpu").numpy().view(np.uint32).tobytes() == \
            np.asarray(jnulls.notnull_bitmap(r)).tobytes()
        assert nulls.isnull_bitmap(c, device="cpu").numpy().view(np.uint32).tobytes() == \
            np.asarray(jnulls.isnull_bitmap(r)).tobytes()
    # SQL NOT over a nullable predicate excludes the nulls
    ge = query.filter_bitmap(col, "ge", 0, device="cpu")
    not_ge = query.bitmap_and(query.bitmap_not(ge, N), nulls.notnull_bitmap(col, device="cpu"))
    assert query.count_bits(not_ge, N) == int(((v < 0) & m).sum())
    assert query.count_bits(nulls.isnull_bitmap(col, device="cpu"), N) == nulls.null_count(col)


def test_attach_valid_drops_the_uploaded_words():
    v = np.arange(N, dtype=np.int32)
    col = gtt.encode(v, "nbit", valid=mask_of("some"))
    first = nulls.valid_words_device(col, "cpu")
    assert nulls.valid_words_device(col, "cpu") is first  # uploaded once per column and device
    assert query.count_where(col, "ge", 0, device="cpu") == int(mask_of("some").sum())
    nulls.attach_valid(col, mask_of("none"))  # no nulls left
    assert nulls.valid_words_device(col, "cpu") is not first
    assert query.count_where(col, "ge", 0, device="cpu") == N


def test_bad_masks_raise():
    v = np.arange(10, dtype=np.int32)
    with pytest.raises(TypeError, match="boolean"):
        nulls.pack_valid(np.ones(10, np.int32))
    with pytest.raises(ValueError, match="shape mismatch"):
        nulls.fill_nulls(v, np.ones(9, bool))
    with pytest.raises(ValueError, match="must have shape"):
        nulls.attach_valid(gtt.encode(v, "nbit"), np.ones(9, bool))
