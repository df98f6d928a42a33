"""Input generators shared by the port's CPU tests and its CUDA tests
(test_torch_cuda.py), and tests of the generators themselves. Imports
nothing of JAX, so the CUDA tests can run where JAX is absent."""

import atexit
import fcntl
import hashlib
import os
import pickle
import zlib

import numpy as np
import pytest

from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP, dtype_to_u32

# NaN, ±Inf, -0.0, values whose v·100 lands at 2^23 - 1, 2^23 and ±(2^23 + 1),
# then the subnormals 1 and 2 ulp, the largest subnormal and -1 ulp
SPECIALS = np.concatenate([
    np.array([np.nan, np.inf, -np.inf, -0.0, (2**23 - 1) / 100, 2**23 / 100, (2**23 + 1) / 100,
              -(2**23 + 1) / 100], np.float32),
    np.array([1, 2, 0x7FFFFF, 0x80000001], np.uint32).view(np.float32),
])


def rng_of(seed: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(seed.encode()))


def salted_prices(n: int, rng: np.random.Generator) -> np.ndarray:
    """Two-decimal float32 prices salted with every value of SPECIALS: at
    the first positions, at random positions (2%), and at 0, n-1 and both
    sides of every group boundary."""
    v = np.round(rng.uniform(0, 1000, n), 2).astype(np.float32)
    if n == 0:
        return v
    edges = np.arange(GROUP, n, GROUP)
    idx = np.concatenate([rng.choice(n, n // 50, replace=False), [0, n - 1], edges - 1, edges])
    v[idx] = SPECIALS[rng.integers(0, SPECIALS.shape[0], idx.shape[0])]
    v[: SPECIALS.shape[0]] = SPECIALS[:n]
    return v


def bitmap_values(d: int, n: int, rng: np.random.Generator, dtype: str = "int32") -> np.ndarray:
    """n values drawn from d distinct random values of dtype (d <= its range)."""
    info = np.iinfo(np.dtype(dtype))
    vocab = rng.choice(np.arange(info.min, info.max + 1, dtype=np.int64), d, replace=False) if info.bits <= 16 else (
        rng.choice(2**31, d, replace=False).astype(np.int64) * rng.choice([-1, 1], d))
    return vocab.astype(np.dtype(dtype))[rng.integers(0, d, n)]


DZBV_KINDS = ["mixed", "skewed", "group_skewed", "one_byte", "two_bytes", "full", "per_tile", "windows"]
# ``windows``: the wide values of the first and the last group
WINDOW_HEAD, WINDOW_TAIL = 100, GROUP - 1100


def dzbv_values(kind: str, n: int, rng: np.random.Generator, per_tile: int = 16, wide_bytes: int = 4) -> np.ndarray:
    """uint32 values for dzbv: ``mixed`` datagen's column (widths 1-4 near
    uniform); ``skewed`` 1-byte values but one 4-byte tile at the start of
    every group (the tile form declines); ``group_skewed`` 1-byte values
    but the first group all 4 bytes wide (the group-row form declines too);
    ``one_byte`` all < 256 (no plane above 0); ``two_bytes`` all < 65536;
    ``full`` 32-bit values; ``per_tile`` exactly ``per_tile`` values
    ``wide_bytes`` wide (2-4: planes 1 to wide_bytes - 1) in every 128-value
    tile, the rest 1 byte; ``windows`` 1-byte values but the first
    WINDOW_HEAD of the first group, every value of the groups between and the
    first WINDOW_TAIL of the last group 4 bytes wide: in the on-disk planes a
    middle group's ranks start 100 bytes into a 4 KB row and touch 9 rows of
    each plane, and the last group's end in the stream's last row."""
    if kind == "mixed":
        return gen_column("dzbv", n, rng).view(np.uint32)
    if kind == "full":
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind in ("one_byte", "two_bytes"):
        return rng.integers(0, 256 if kind == "one_byte" else 65536, n).astype(np.uint32)
    v = rng.integers(0, 256, n).astype(np.uint32)
    wide = rng.integers(2 ** (8 * wide_bytes - 8), 2 ** (8 * wide_bytes), n, dtype=np.uint64).astype(np.uint32)
    if kind == "skewed":
        sel = (np.arange(n) % GROUP) < 128
    elif kind == "group_skewed":
        sel = np.arange(n) < GROUP
    elif kind == "windows":
        p, last = np.arange(n), (n - 1) // GROUP * GROUP
        sel = (p < WINDOW_HEAD) | ((p >= GROUP) & (p < last)) | ((p >= max(last, GROUP)) & (p < last + WINDOW_TAIL))
    elif kind == "per_tile":
        tiles = -(-n // 128)
        order = np.argsort(rng.random((tiles, 128)), axis=1)[:, :per_tile]
        sel = np.zeros((tiles, 128), bool)
        np.put_along_axis(sel, order, True, axis=1)
        sel = sel.reshape(-1)[:n]
    else:
        raise ValueError(kind)
    return np.where(sel, wide, v)


SCAN_DTYPES = ["int32", "uint32", "float32", "int8", "int16", "uint8", "uint16"]
OPS = ["eq", "ne", "lt", "le", "gt", "ge"]


def scan_values(dtype: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """n values of dtype for the scan layer: integers over the dtype's
    whole range with its two ends and 0 salted in; float32 salted prices
    (NaN, ±Inf, -0.0, subnormals) with random signs."""
    if dtype == "float32":
        return salted_prices(n, rng) * rng.choice(np.array([-1, 1], np.float32), n)
    info = np.iinfo(np.dtype(dtype))
    v = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True)
    v[rng.integers(0, max(n, 1), min(n, 30))] = rng.choice([info.min, info.max, 0], min(n, 30))
    return v.astype(np.dtype(dtype))


def scan_thresholds(dtype: str, v: np.ndarray) -> list:
    """Comparison values: a value of the column, the dtype's ends, one past
    them (mod-2^32 staging), and for floats ±0.0, ±Inf and NaN."""
    if dtype == "float32":
        return [float(v[len(v) // 2]) if len(v) else 1.5, 0.0, -0.0, np.inf, -np.inf, np.nan]
    info = np.iinfo(np.dtype(dtype))
    return [int(v[len(v) // 2]) if len(v) else 7, int(info.min), int(info.max), int(info.max) + 1, 2**32 + 5]


def scan_key(v: np.ndarray) -> np.ndarray:
    """Logical values as int64 keys in the scan's order: integers as they
    are, float32 in IEEE total order (-NaN < -Inf < ... < -0.0 < +0.0 <
    ... < +Inf < +NaN)."""
    if v.dtype.kind != "f":
        return v.astype(np.int64)
    b = v.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF) - 1, b)


def staged_key(value, dtype: str) -> int:
    """The comparison value as a scan_key: floats through float32, signed
    integers wrapped to int32 and unsigned ones to uint32 (mod 2^32)."""
    if dtype == "float32":
        return int(scan_key(np.array([value], np.float32))[0])
    wrapped = int(value) % 2**32
    return wrapped - 2**32 if np.dtype(dtype).kind == "i" and wrapped >= 2**31 else wrapped


def want_mask(v: np.ndarray, op: str, value, valid: np.ndarray | None = None) -> np.ndarray:
    """bool[n]: the predicate on each value, False at null rows."""
    k, c = scan_key(v), staged_key(value, v.dtype.name)
    hit = {"eq": k == c, "ne": k != c, "lt": k < c, "le": k <= c, "gt": k > c, "ge": k >= c}[op]
    return hit if valid is None else hit & valid


WIDE_KINDS = ["int64", "orderkey", "uint64", "float64"]


def wide_values(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """n 64-bit values: ``int64`` over the whole range with both ends, -1
    and 0 salted in; ``orderkey`` sorted int64 keys with 1-7 rows a key
    (TPC-H's l_orderkey) that start at -3 * 2^32 and cross 0, so the hi
    plane takes several values of both signs and the lo plane wraps;
    ``uint64`` over the whole range with 0, 2^63 and 2^64 - 1 salted in;
    ``float64`` normal values with NaN, -NaN, ±Inf, ±0.0, the smallest
    subnormal and the largest finite value salted in."""
    salt = rng.integers(0, max(n, 1), min(n, 40))
    if kind == "orderkey":
        keys = -3 * 2**32 + np.cumsum(rng.integers(1, 4, n)) * 2**20
        return np.repeat(keys, rng.integers(1, 8, n))[:n].astype(np.int64)
    if kind == "float64":
        v = rng.normal(0, 1e6, n)
        specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, np.finfo(np.float64).max])
        v[salt] = specials[rng.integers(0, specials.shape[0], salt.shape[0])]
        return v
    info = np.iinfo(np.dtype(kind))
    v = rng.integers(info.min, info.max, n, dtype=np.dtype(kind), endpoint=True)
    ends = [info.min, info.max, 0, 2**63] if kind == "uint64" else [info.min, info.max, -1, 0]
    v[salt] = np.array(ends, np.dtype(kind))[rng.integers(0, len(ends), salt.shape[0])]
    return v


def wide_thresholds(v: np.ndarray) -> list:
    """Comparison values for a 64-bit column: one of its values, the
    dtype's ends, and for floats ±0.0, ±Inf and NaN."""
    mid = v[len(v) // 2].item() if len(v) else 7
    if v.dtype.kind == "f":
        return [mid, 0.0, -0.0, np.inf, -np.inf, np.nan]
    info = np.iinfo(v.dtype)
    return [mid, int(info.min), int(info.max), 0]


def wide_key(v: np.ndarray) -> np.ndarray:
    """64-bit logical values as keys in the scan's order: integers as they
    are, float64 as uint64 keys in IEEE total order."""
    if v.dtype.kind != "f":
        return v
    u = v.view(np.uint64)
    return np.where(u >> np.uint64(63), ~u, u | np.uint64(2**63))


def want_wide_mask(v: np.ndarray, op: str, value, valid: np.ndarray | None = None) -> np.ndarray:
    """bool[n]: the predicate on each 64-bit value, False at null rows."""
    k, c = wide_key(v), wide_key(np.array([value], v.dtype))[0]
    hit = {"eq": k == c, "ne": k != c, "lt": k < c, "le": k <= c, "gt": k > c, "ge": k >= c}[op]
    return hit if valid is None else hit & valid


PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
# Each string kind -> the inner scheme that codes_scheme="auto" picks for it.
STRING_KINDS = {"runs": "rle", "priority": "nbit", "distinct": "delta", "banded": "for"}


def string_values(kind: str, n: int, rng: np.random.Generator) -> list:
    """n strings: ``runs`` TPC-H's o_orderpriority in runs of ~50; ``priority``
    the same five drawn at random with a few multibyte ones; ``distinct``
    sorted strings all different (codes 0..n-1); ``banded`` 16 strings a
    group, each group's 16 after the last one's (codes that a frame of
    reference packs narrower than nbit or delta)."""
    if kind == "runs":
        return [PRIORITIES[i] for i in np.repeat(rng.integers(0, 5, n // 50 + 1), 50)[:n]]
    if kind == "priority":
        vocab = PRIORITIES + ["ünïcødé", "日本語"]
        return [vocab[i] for i in rng.integers(0, len(vocab), n)]
    if kind == "distinct":
        return [f"Clerk#{i:09d}" for i in range(n)]
    band = np.arange(n) // GROUP * 16 + rng.integers(0, 16, n)
    return [f"s{c:05d}" for c in band]


def want_agg(v: np.ndarray, agg: str, valid: np.ndarray | None = None):
    """sum (exact int, or float64 in NumPy's order), min or max (total order
    for floats) of the non-null values."""
    if valid is not None:
        v = v[valid]
    if agg == "sum":
        return float(np.sum(v, dtype=np.float64)) if v.dtype.kind == "f" else int(v.astype(np.int64).sum())
    k = scan_key(v)
    i = int(np.argmax(k) if agg == "max" else np.argmin(k))
    return v[i].item() if v.dtype.kind == "f" else int(v[i])


def assert_same_column(port, ref):
    """Two EncodedColumns alike: name, scheme, dtype, n, params, and every
    stream's dtype, shape and bytes."""
    assert (port.name, port.scheme, port.dtype, port.n) == (ref.name, ref.scheme, ref.dtype, ref.n)
    assert port.params == ref.params
    assert sorted(port.streams) == sorted(ref.streams)
    for k, s in ref.streams.items():
        p = port.streams[k]
        assert (p.dtype, p.shape) == (s.dtype, s.shape), k
        assert p.tobytes() == s.tobytes(), k


def _maps(pid: int) -> int:
    with open(f"/proc/{pid}/maps") as f:
        return sum(1 for _ in f)


class FreshProcess:
    """A fresh Python process (multiprocessing's spawn) that runs importable
    functions (a test module's top-level ones) and pickles their results
    back: started at the first call, ended by close(). The CPU tests run
    the JAX reference there where they trace many programs: an xdist worker
    keeps every program it compiles, and one that maps more than
    vm.max_map_count (65530) dies in LLVM and can hang the run (ROADMAP.md,
    "Working conditions"). So the process is ended after a call that
    leaves it with more than MAX_MAPS memory maps (half the limit; one
    call of the reference adds a few thousand), and the next call starts a
    new one.
    A process that dies fails the call (BrokenProcessPool) instead, and the
    next call starts a new one."""

    MAX_MAPS = 32768

    def __init__(self):
        self._pool = None
        self._pid = None

    def __call__(self, fn, *args, **kwargs):
        from concurrent.futures.process import BrokenProcessPool

        if self._pool is None:
            import concurrent.futures
            import multiprocessing

            self._pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
            self._pid = self._pool.submit(os.getpid).result()
        try:
            result = self._pool.submit(fn, *args, **kwargs).result()
        except BrokenProcessPool:
            self.close()
            raise
        if _maps(self._pid) > self.MAX_MAPS:
            self.close()
        return result

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


# The reference's calls of the port's CPU tests: one process a worker,
# started at its first call and left to end with the worker, so that a
# worker that takes cases of several test modules spawns and imports JAX
# once. A module that changes the reference's process-wide state
# (test_torch_bigcolumn's lowered limit) keeps a FreshProcess of its own.
JAX = FreshProcess()
atexit.register(JAX.close)


def in_fresh_process(fn, *args):
    """fn(*args) in a FreshProcess of its own."""
    process = FreshProcess()
    try:
        return process(fn, *args)
    finally:
        process.close()


def once_per_run(tmp_path_factory, name: str, compute):
    """``(root, compute(root))``, computed once per test run: ``root`` is
    the directory ``name`` in the base temp directory that every xdist
    worker of the run shares (the run's own without xdist). The first
    worker to ask computes under an fcntl lock and pickles the result
    beside ``root``; a worker that asks meanwhile waits for the lock, then
    loads the pickle. So a heavy reference that ``compute`` runs (in a
    FreshProcess) costs the run once, not once a worker that takes a case
    of its file. A compute that raises leaves no pickle: the next worker
    tries again, and fails the same way."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root, done = base / name, base / f"{name}.pickle"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if done.exists():
            return root, pickle.loads(done.read_bytes())
        root.mkdir(exist_ok=True)
        result = compute(root)
        done.write_bytes(pickle.dumps(result))
        return root, result


class ReferenceParts:
    """A test module's reference answers, part by part: ``parts(*part)`` is
    ``fn(*part)`` run in JAX (which may keep what the parts share, such as
    the reference's table) and kept for the run by once_per_run. So the
    xdist workers that take a module's cases each compute only the parts
    those cases read, at the same time, and no part is computed twice in a
    run."""

    def __init__(self, tmp_path_factory, name: str, fn):
        self.tmp_path_factory, self.name, self.fn = tmp_path_factory, name, fn

    def __call__(self, *part):
        key = f"{self.name}-{hashlib.sha1(repr(part).encode()).hexdigest()[:16]}"
        return once_per_run(self.tmp_path_factory, key, lambda root: JAX(self.fn, *part))[1]


def wrapping_walk(n: int, rng: np.random.Generator) -> np.ndarray:
    """An int32 random walk whose steps span the whole int32 range, so it
    wraps past both ends and its deltas take both signs at full width."""
    steps = rng.integers(-(2**31), 2**31, n, dtype=np.int64)
    steps[rng.integers(0, max(n, 1), min(n, 8))] = -(2**31)  # the largest negative step
    return np.cumsum(steps).astype(np.uint32).view(np.int32)


def for_values(n: int, rng: np.random.Generator) -> np.ndarray:
    """int32 values within 4096 of the int32 sign boundary on both sides:
    as uint32 payloads they sit at 2^31 - 2048 .. 2^31 + 2047, so the
    unsigned frame min is not the signed one."""
    return (2**31 - 2048 + rng.integers(0, 4096, n)).astype(np.uint32).view(np.int32)


DICT_KINDS = ["negative", "u32_high", "floats", "int8", "int16"]


def dict_values(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """n values from a small vocabulary: ``negative`` int32 with both ends
    and negatives; ``u32_high`` uint32 on both sides of 2^31; ``floats``
    float32 with -0.0, 0.0, NaN, -NaN and ±Inf; ``int8``/``int16`` signed
    narrow values (their payloads zero-extend)."""
    if kind == "negative":
        vocab = np.array([-(2**31), 2**31 - 1, -1, 0, 1, -70, 55, -123_456_789], np.int32)
    elif kind == "u32_high":
        vocab = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1, 3_000_000_000], np.uint32)
    elif kind == "floats":
        vocab = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -2.25], np.float32)
    else:
        info = np.iinfo(np.dtype(kind))
        vocab = np.array([info.min, info.max, -1, 0, 1, -7], np.dtype(kind))
    return vocab[rng.integers(0, vocab.shape[0], n)]


# Hand-made K5 tables. Every case but "outside" is in the form the host
# prep makes (rle.tile_prep): ends non-decreasing, at most w_pad - 1 of
# them below the tile width W, the rest W. "outside" holds ends below 0
# and above W too, which the wrapper also takes.
RUN_TABLE_CASES = ["random", "equal", "zeros", "ones", "straddle", "pad", "outside"]


def run_tables(case: str, w_pad: int, tiles: int, ng: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(ends_w, vals_w): ng * tiles int32 tables of w_pad runs, each over a
    tile of W = GROUP // tiles positions. "equal" repeats a few ends (the
    last counted entry among them), "zeros" starts with ends of 0, "ones"
    has runs of length 1 (w_pad - 1 ends in the tile's first 128
    positions), "straddle" puts w_pad - 1 consecutive ends across position
    1024 (a K5 warp's span edge; the tile's end where W <= 1024), "pad" has
    no end below W. When ng > 1 the last group's second half of tiles is
    all pad, as a ragged column's last group is."""
    rng = np.random.default_rng(seed)
    width = GROUP // tiles
    ends = np.full((ng * tiles, w_pad), width, np.int64)
    for i in range(ng * tiles):
        if ng > 1 and i >= (ng - 1) * tiles + tiles // 2:
            continue
        if case == "random":
            real = rng.integers(0, width, rng.integers(0, w_pad))
        elif case == "equal":
            real = rng.choice([0, 1, width // 2, width // 2 + 1, width - 1], w_pad - 1)
        elif case == "zeros":
            real = np.concatenate([np.zeros(w_pad // 2, np.int64), rng.integers(0, width, w_pad // 2 - 1)])
        elif case == "ones":
            real = np.arange(1, w_pad)
        elif case == "straddle":
            real = min(width - w_pad, max(0, 1024 - w_pad // 2)) + np.arange(w_pad - 1)
        elif case == "pad":
            real = np.zeros(0, np.int64)
        else:
            real = np.concatenate([[-5, width + 50], rng.integers(0, width, w_pad - 2)])
        ends[i, : real.shape[0]] = np.sort(real)
    vals = rng.integers(0, 2**32, ends.shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return ends.astype(np.int32), vals


RUN_SPECIALS = np.array([-0.0, 0.0, np.nan, -np.nan], np.float32)


def run_table_values(dtype: str, shape: tuple, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(table, values): scan_values of dtype, for floats with -0.0, +0.0,
    NaN and -NaN salted in, and the same values as tile-form run tables
    carry them, int32 bits of the zero-extended uint32 payloads."""
    v = scan_values(dtype, int(np.prod(shape)), rng)
    if dtype == "float32":
        v[rng.integers(0, v.size, 8)] = np.tile(RUN_SPECIALS, 2)
    return dtype_to_u32(v).view(np.int32).reshape(shape), v


def scan_runs(dtype: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """n values of dtype in runs of 1-399 rows, each run one of 64
    scan_values (for floats -0.0, +0.0, NaN and -NaN among them): an rle or
    rpe column that takes the tile form."""
    pool = scan_values(dtype, 64, rng)
    if dtype == "float32":
        pool[: RUN_SPECIALS.size] = RUN_SPECIALS
    lengths = rng.integers(1, 400, n // 100)
    return np.repeat(pool[rng.integers(0, pool.size, lengths.size)], lengths)[:n]


@pytest.mark.parametrize("case", RUN_TABLE_CASES)
def test_run_tables_are_what_they_name(case):
    for w_pad, tiles in ((8, 1), (32, 64), (128, 32)):
        ends, vals = run_tables(case, w_pad, tiles, 3)
        width = GROUP // tiles
        assert ends.shape == vals.shape == (3 * tiles, w_pad) and ends.dtype == vals.dtype == np.int32
        assert (np.diff(ends, axis=1) >= 0).all()
        assert (ends[-(tiles // 2 or 1):] == width).all() if tiles > 1 else True
        below = (ends < width).sum(axis=1)
        if case == "outside":
            assert (ends < 0).any() and (ends > width).any()
            continue
        assert (below <= w_pad - 1).all() and (ends >= 0).all() and (ends <= width).all()
        first = ends[0]
        assert {"pad": below[0] == 0, "ones": (first[: w_pad - 1] == np.arange(1, w_pad)).all(),
                "zeros": (first[: w_pad // 2] == 0).all(), "equal": np.unique(first[: w_pad - 1]).shape[0] < w_pad - 1,
                "straddle": (np.diff(first[: w_pad - 1]) == 1).all() and (first[0] < 1024 <= first[w_pad - 2]
                                                                          or width <= 1024),
                "random": True}[case]


@pytest.mark.parametrize("dtype", SCAN_DTYPES)
def test_scan_runs_and_run_table_values_are_what_they_name(dtype):
    rng = rng_of(f"inputs/runs/{dtype}")
    v = scan_runs(dtype, 3 * GROUP + 17, rng)
    assert v.dtype == np.dtype(dtype) and v.shape == (3 * GROUP + 17,)
    bits = v.view(np.uint8).reshape(v.size, -1)
    runs = 1 + int((bits[1:] != bits[:-1]).any(axis=1).sum())
    assert runs <= v.size // 50  # runs of ~200 rows
    table, values = run_table_values(dtype, (6, 8), rng)
    assert table.shape == (6, 8) and table.dtype == np.int32
    assert (table.reshape(-1).view(np.uint32) == dtype_to_u32(values)).all()
    if dtype == "float32":
        for special in RUN_SPECIALS.view(np.uint32):
            assert (v.view(np.uint32) == special).any() and (values.view(np.uint32) == special).any()


def test_scan_oracle_orders_floats_totally():
    v = np.array([np.nan, -np.nan, -np.inf, np.inf, -0.0, 0.0, -1.5, 1.5], np.float32)
    order = np.argsort(scan_key(v), kind="stable")
    assert v[order].view(np.uint32).tolist() == np.array(
        [-np.nan, -np.inf, -1.5, -0.0, 0.0, 1.5, np.inf, np.nan], np.float32).view(np.uint32).tolist()
    assert want_mask(v, "eq", -0.0).tolist() == [False] * 4 + [True] + [False] * 3
    assert staged_key(2**32 + 5, "int32") == 5 and staged_key(-1, "uint8") == 2**32 - 1
    assert want_agg(np.array([2**31 - 1] * 3, np.int32), "sum") == 3 * (2**31 - 1)


def test_salted_prices_hold_every_special_at_the_group_edges():
    n = 2 * GROUP + 999
    v = salted_prices(n, rng_of("salted"))
    bits = v.view(np.uint32)
    assert v.dtype == np.float32 and v.shape == (n,)
    assert bits[: SPECIALS.shape[0]].tobytes() == SPECIALS.tobytes()
    assert set(SPECIALS.view(np.uint32)) <= set(bits)
    edge = [0, GROUP - 1, GROUP, 2 * GROUP - 1, 2 * GROUP, n - 1]
    assert set(bits[edge]) <= set(SPECIALS.view(np.uint32))
    assert salted_prices(0, rng_of("salted")).shape == (0,)
    assert salted_prices(5, rng_of("salted")).view(np.uint32).tolist() == SPECIALS[:5].view(np.uint32).tolist()


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16", "int32"])
def test_bitmap_values_have_d_distinct_values(dtype):
    d = 12
    v = bitmap_values(d, 4 * GROUP, rng_of(dtype), dtype)
    assert v.dtype == np.dtype(dtype) and v.shape == (4 * GROUP,)
    assert np.unique(v).shape == (d,)
    assert np.array_equal(bitmap_values(d, 100, rng_of(dtype), dtype), bitmap_values(d, 100, rng_of(dtype), dtype))


def test_model_frame_len_default_is_one_group():
    n = 3 * GROUP + 5
    want = gen_column("model", n, rng_of("model"))
    assert gen_column("model", n, rng_of("model"), frame_len=GROUP).tobytes() == want.tobytes()


@pytest.mark.parametrize("frame_len", [GROUP, 4 * GROUP])
def test_model_frames_are_quadratic_plus_noise(frame_len):
    """Each frame of the model column is a quadratic in the position within
    the frame (mod 2^32) plus noise in [-7, 7]: its third differences are
    the noise's, at most (1 + 3 + 3 + 1)·7."""
    n = 2 * frame_len + 77
    v = gen_column("model", n, rng_of(f"arcs{frame_len}"), frame_len=frame_len).view(np.uint32).astype(np.int64)
    for f in range(-(-n // frame_len)):
        seg = v[f * frame_len : (f + 1) * frame_len]
        d3 = np.diff(seg, 3)
        d3 = (d3 + 2**31) % 2**32 - 2**31  # differences of a wrapped sequence, taken mod 2^32
        assert np.abs(d3).max() <= 8 * 7


def _widths(v: np.ndarray) -> np.ndarray:
    return 1 + (v > 0xFF).astype(int) + (v > 0xFFFF) + (v > 0xFFFFFF)


@pytest.mark.parametrize("kind", DZBV_KINDS)
def test_dzbv_values_have_the_widths_they_name(kind):
    n = 3 * GROUP + 17
    v = dzbv_values(kind, n, rng_of(kind), per_tile=5)
    w = _widths(v)
    assert v.dtype == np.uint32 and v.shape == (n,)
    assert v.tobytes() == dzbv_values(kind, n, rng_of(kind), per_tile=5).tobytes()
    if kind == "mixed":
        assert set(np.unique(w)) == {1, 2, 3, 4}
    elif kind in ("one_byte", "two_bytes"):
        assert w.max() == (1 if kind == "one_byte" else 2)
    elif kind == "full":
        assert (w == 4).mean() > 0.99
    else:
        wide = (w == 4).reshape(-1)
        assert set(np.unique(w)) <= {1, 4}
        if kind == "skewed":
            assert np.array_equal(wide, np.arange(n) % GROUP < 128)
        elif kind == "group_skewed":
            assert np.array_equal(wide, np.arange(n) < GROUP)
        elif kind == "windows":
            counts = np.add.reduceat(wide, np.arange(0, n, GROUP))
            assert counts.tolist() == [WINDOW_HEAD, GROUP, GROUP, 17]
            full = dzbv_values(kind, 4 * GROUP, rng_of(kind))
            assert np.add.reduceat(_widths(full) == 4, np.arange(0, 4 * GROUP, GROUP)).tolist() == [
                WINDOW_HEAD, GROUP, GROUP, WINDOW_TAIL]
        else:
            assert (np.add.reduceat(wide, np.arange(0, n, 128))[: n // 128] == 5).all()


@pytest.mark.parametrize("wide_bytes", [2, 3, 4])
def test_dzbv_per_tile_values_are_wide_bytes_wide(wide_bytes):
    """per_tile puts exactly per_tile values wide_bytes wide in every tile
    (the CUDA tests' columns with planes {1}, {1, 2}, {1, 2, 3})."""
    n = 2 * GROUP
    w = _widths(dzbv_values("per_tile", n, rng_of(f"wide{wide_bytes}"), per_tile=24, wide_bytes=wide_bytes))
    assert set(np.unique(w)) == {1, wide_bytes}
    assert ((w == wide_bytes).reshape(-1, 128).sum(axis=1) == 24).all()


def test_wrapping_walk_crosses_the_int32_wrap():
    v = wrapping_walk(3 * GROUP + 11, rng_of("walk"))
    d = np.diff(v.astype(np.int64))
    assert v.dtype == np.int32 and (d > 2**31 - 1).any() and (d < -(2**31)).any()


@pytest.mark.parametrize("kind", DICT_KINDS)
def test_dict_values_hold_their_edge_values(kind):
    v = dict_values(kind, 4 * GROUP, rng_of(kind))
    u = v.view(np.uint32) if v.itemsize == 4 else v.astype(np.int64)
    if kind == "floats":
        assert {0x80000000, 0x00000000, 0x7FC00000, 0xFFC00000} <= set(np.unique(u).tolist())
    elif kind == "u32_high":
        assert u.min() < 2**31 <= u.max()
    else:
        assert v.min() < 0 < v.max()


def test_fresh_process_ends_past_its_map_limit(monkeypatch):
    """The process stays while under MAX_MAPS, is ended after the call that
    leaves it over, and the next call starts a new one."""
    process = FreshProcess()
    try:
        first = process(os.getpid)
        assert first != os.getpid() and process(os.getpid) == first
        monkeypatch.setattr(process, "MAX_MAPS", 0)
        assert process(os.getpid) == first and process(os.getpid) != first
    finally:
        process.close()


def test_once_per_run_computes_once(tmp_path_factory):
    """A second ask loads the first one's pickle: compute does not run
    again, and the directory is the same."""
    calls = []

    def compute(root):
        calls.append(root)
        (root / "written").write_text("x")
        return {"answer": np.arange(3)}

    name = f"once-{os.getpid()}"
    first, again = once_per_run(tmp_path_factory, name, compute), once_per_run(tmp_path_factory, name, compute)
    assert len(calls) == 1 and first[0] == again[0] == calls[0] and (first[0] / "written").read_text() == "x"
    assert np.array_equal(first[1]["answer"], again[1]["answer"])
