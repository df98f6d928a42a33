"""giddy_tpu_torch.strings against giddy_tpu.strings on the CPU, from the
same numpy-seeded string columns, one for each inner scheme that
``codes_scheme="auto"`` picks (AUTO_INNER), plus nullable and bytes
columns: encode byte for byte, decode and decode_columns as equal object
arrays, every string predicate's bitmap word for word (pad bits included),
count_where_str, select_where_str, isin_bitmap_str (code ranges and the
fragmented lookup), dict_mask_bitmap, min_str/max_str/distinct_count_str.
The codes decode through the port's plain kernel versions and the
reference's Pallas kernels in interpret mode. Tolerance 0."""

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu import query as jq
from giddy_tpu import strings as js
from giddy_tpu_torch import query, strings
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import STRING_KINDS, assert_same_column, rng_of, string_values

N = 2 * GROUP + 999  # three groups, the last one ragged


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (string kind, as bytes, nullable); every inner scheme of AUTO_INNER once
CASES = [(k, False, False) for k in STRING_KINDS] + [("priority", True, True), ("runs", False, True)]
IDS = [f"{k}{'-bytes' if b else ''}{'-nulls' if nul else ''}" for k, b, nul in CASES]
_COLUMNS = {}


def column(case: int):
    """(values as an object array, validity or None, reference, port column)."""
    if case not in _COLUMNS:
        kind, as_bytes, nullable = CASES[case]
        rng = rng_of(f"strings/{IDS[case]}")
        vals = string_values(kind, N, rng)
        if as_bytes:
            vals = [s.encode() for s in vals]
        valid = rng.random(N) > 0.15 if nullable else None
        ref = js.encode_strings(vals, valid=valid, name="s")
        _COLUMNS[case] = np.array(vals, dtype=object), valid, ref, gtt.from_reference(ref)
    return _COLUMNS[case]


def words(bm) -> bytes:
    return bm.numpy().view(np.uint32).tobytes() if isinstance(bm, torch.Tensor) else np.asarray(bm).tobytes()


def probes(vals: np.ndarray) -> list[tuple[str, object]]:
    """(op, value) pairs: every op at a present value, an absent value
    and a prefix; startswith and contains at a prefix and an infix."""
    mid, first = vals[len(vals) // 2], vals[0]
    cut = lambda s, a, b: s[a:b]  # noqa: E731
    absent = b"zz-absent" if isinstance(mid, bytes) else "zz-absent"
    out = [(op, x) for op in ("eq", "ne", "lt", "le", "gt", "ge") for x in (mid, absent)]
    return out + [("startswith", cut(mid, 0, 3)), ("startswith", first), ("contains", cut(mid, 2, 4)),
                  ("contains", absent), ("lt", cut(first, 0, 1))]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_encode_and_decode_match_jax(case):
    vals, valid, ref, col = column(case)
    kind, _, _ = CASES[case]
    assert ref.params["codes_scheme"] == STRING_KINDS[kind]
    assert_same_column(strings.encode_strings(list(vals), valid=valid, name="s"), ref)
    want = js.decode(ref)
    for got in (strings.decode(col, device="cpu"), gtt.decode(col, device="cpu"), strings.decode_ref(col),
                gtt.decode_columns([col], device="cpu")["s"]):
        assert got.dtype == object and np.array_equal(got, want)
    if valid is None:
        assert np.array_equal(want, vals)
    else:
        assert np.array_equal(want[valid], vals[valid])
        out, mask = strings.decode_masked_strings(col, device="cpu")
        assert np.array_equal(out, want) and np.array_equal(mask, valid)
    assert np.array_equal(strings.dictionary(col), js.dictionary(ref))
    assert strings.code_set(col, [vals[0], "nope"]) == js.code_set(ref, [vals[0], "nope"])


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_string_predicates_match_jax(case):
    vals, valid, ref, col = column(case)
    for op, value in probes(vals):
        bm = strings.filter_bitmap_str(col, op, value, device="cpu")
        assert bm.dtype == torch.int32 and words(bm) == words(js.filter_bitmap_str(ref, op, value)), (op, value)
        want = js.count_where_str(ref, op, value)
        assert strings.count_where_str(col, op, value, device="cpu") == want
        pyop = {"eq": lambda e: e == value, "ne": lambda e: e != value, "lt": lambda e: e < value,
                "le": lambda e: e <= value, "gt": lambda e: e > value, "ge": lambda e: e >= value,
                "startswith": lambda e: e.startswith(value), "contains": lambda e: value in e}[op]
        hit = np.fromiter((pyop(e) for e in js.decode_ref(ref)), bool, count=N)
        assert want == int((hit if valid is None else hit & valid).sum())
    with pytest.raises(ValueError, match="op must be one of"):
        strings.filter_bitmap_str(col, "like", "x", device="cpu")


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_select_isin_and_aggregates_match_jax(case):
    vals, valid, ref, col = column(case)
    op, value = "lt", vals[len(vals) // 3]
    got = strings.select_where_str(col, op, value, device="cpu")
    assert got.dtype == object and np.array_equal(got, js.select_where_str(ref, op, value))
    dic = js.dictionary(ref)
    for picks in (list(dic[:2]) + ["absent"], list(dic[::2]), []):  # ranges, fragmented (> 8 ranges), empty
        bm = strings.isin_bitmap_str(col, picks, device="cpu")
        assert words(bm) == words(js.isin_bitmap_str(ref, picks))
    mask = np.arange(dic.shape[0]) % 3 == 1
    assert words(strings.dict_mask_bitmap(col, mask, device="cpu")) == words(js.dict_mask_bitmap(ref, mask))
    assert strings.min_str(col) == js.min_str(ref) and strings.max_str(col) == js.max_str(ref)
    assert strings.distinct_count_str(col) == js.distinct_count_str(ref)
    assert words(query.bitmap_not(strings.filter_bitmap_str(col, "eq", value, device="cpu"), N)) == words(
        jq.bitmap_not(js.filter_bitmap_str(ref, "eq", value), N))


def test_all_null_and_empty_columns():
    col = gtt.from_reference(js.encode_strings([b"x", b"y"], valid=np.zeros(2, bool)))
    assert strings.distinct_count_str(col) == 0
    with pytest.raises(ValueError, match="all-null"):
        strings.min_str(col)
    assert list(strings.decode(col, device="cpu")) == [b"", b""]
    with pytest.raises(ValueError, match="empty string column"):
        strings.encode_strings([])
    with pytest.raises(TypeError, match="str or bytes"):
        strings.encode_strings([1, 2])
    with pytest.raises(ValueError, match="needs a 'strdict' column"):
        strings.filter_bitmap_str(gtt.encode(np.zeros(3, np.int32), "nbit"), "eq", "x", device="cpu")
