"""Whole runs on the CPU at a small table: the harness with its look for
a card skipped, sound and with the timed path broken underneath (a value
or count altered, half left out, a stale answer, an answer served from a
cache with no kernel behind it); the control put in the program's place;
the command without a card; the no-JAX guard; and a configuration, a mix,
a loop and a metric added as new files."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import cells, control, guard, harness
from giddy_tpu_torch import api, kernels, query
from giddy_tpu_torch.kernels import lanes

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
DECODE = [c for c in CELLS if c.endswith(".decode")]
QUERY = [c for c in CELLS if not c.endswith(".decode")]
SEED = 2**31 + 99


def run(name, rows, seconds=0.4, trace=False, **kw):
    result, checks = harness.run(cells.resolve(ROOT, name), SEED, seconds, trace, "cpu", rows=rows, **kw)
    return result, dict((k, v) for k, v, _ in checks)


@pytest.fixture
def cpu_launches(monkeypatch):
    """The port's launch counters moving on the CPU as they do on a card:
    each kernel wrapper's CPU fallback (kernels/lanes.<kernel>) counts a
    launch in its wrapper's module."""
    for name, mod in kernels.WRAPPERS.items():
        fn = getattr(lanes, name, None)
        if fn is None or isinstance(mod.LAUNCHES, dict):
            continue

        def counted(*a, _fn=fn, _mod=mod, **k):
            _mod.LAUNCHES += 1
            return _fn(*a, **k)
        monkeypatch.setattr(lanes, name, counted)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, rows):
    result, checks = run(name, rows)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert all(v == 0 for v in checks.values())
    cell = cells.resolve(ROOT, name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_launches_a_kernel_each_call(name, rows, cpu_launches):
    result, checks = run(name, rows, count_launches=True)
    assert result["correct"] and checks["unlaunched_calls"] == 0


@pytest.mark.parametrize("name", [DECODE[0], QUERY[0]])
def test_traced_run_reports_per_layer_metrics(name, rows):
    result, _ = run(name, rows, trace=True)
    cell = cells.resolve(ROOT, name)
    # on the CPU only the host clock's metrics have something to read
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert result["device"]["window_s"] > 0 and "breakdown" in result and result["correct"]
    if name in DECODE:  # read from the untraced window that comes first
        assert result["metrics"]["issue_us.decode"]["value"] > 0


def altered(fn):
    """A decoder whose output has one value altered where it is produced."""
    def dec(streams):
        out = fn(streams).clone()
        out[7] += 1
        return out
    return dec


def half(fn):
    """A decoder that leaves out the second half of the groups."""
    def dec(streams):
        out = fn(streams).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return dec


def unchanged(fn):
    """A decoder that hands back its first output on every call."""
    memo = []

    def dec(streams):
        if not memo:
            memo.append(fn(streams))
        return memo[0]
    return dec


@pytest.mark.parametrize("name", DECODE)
@pytest.mark.parametrize("fault", [altered, half, unchanged])
def test_broken_decode_is_not_correct(name, fault, rows, monkeypatch):
    real = api.get_decoder
    monkeypatch.setattr(api, "get_decoder", lambda col, *a: fault(real(col, *a)))
    result, checks = run(name, rows)
    assert not result["correct"] and checks["wrong_values"] > 0


def count_plus_one(real):
    return lambda words, n: real(words, n) + 1


def count_half(real):
    """The count over the first half of the bitmap, doubled."""
    return lambda words, n: 2 * real(words[: words.shape[0] // 2], n // 2)


def count_stale(real):
    memo = []

    def count(words, n):
        if not memo:
            memo.append(real(words, n))
        return memo[0]
    return count


@pytest.mark.parametrize("name", QUERY)
@pytest.mark.parametrize("fault", [count_plus_one, count_half, count_stale])
def test_broken_query_is_not_correct(name, fault, rows, monkeypatch):
    monkeypatch.setattr(query, "count_bits", fault(query.count_bits))
    result, checks = run(name, rows)
    assert not result["correct"] and checks["wrong_counts"] > 0


def memo_scan(real):
    """A scan that serves each (column, op, value) it has seen from a
    cache: exact answers, with no kernel behind them."""
    memo = {}

    def scan(col, op, value, **kw):
        key = (col.name, op, value)
        if key not in memo:
            memo[key] = real(col, op, value, **kw)
        return memo[key]
    return scan


@pytest.mark.parametrize("name", QUERY)
def test_cached_scan_is_not_correct(name, rows, cpu_launches, monkeypatch):
    monkeypatch.setattr(query, "filter_bitmap", memo_scan(query.filter_bitmap))
    result, checks = run(name, rows, seconds=0.6, count_launches=True)
    assert checks["wrong_counts"] == 0  # the answers are right: only the launch count shows the cache
    assert not result["correct"] and checks["unlaunched_calls"] > 0


@pytest.mark.parametrize("name", DECODE)
def test_cached_decode_is_not_correct(name, rows, cpu_launches, monkeypatch):
    real = api.get_decoder
    monkeypatch.setattr(api, "get_decoder", lambda col, *a: unchanged(real(col, *a)))
    result, checks = run(name, rows, count_launches=True)
    assert not result["correct"] and checks["unlaunched_calls"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, rows):
    """The reference in float16, put in the program's place through a whole
    run, reads not correct by its values or counts alone."""
    result, checks = run(name, rows, sut=control)
    assert not result["correct"] and result["failed"] == 0
    assert checks.get("wrong_values", 0) + checks.get("wrong_counts", 0) > 0


def command(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "5",
                           "--seconds", "1", "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)


def test_refuses_without_a_card():
    p = command(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == "" and "needs 1 CUDA card" in p.stderr


def test_refuses_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("results", "__pycache__"))
    p = command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_guard_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "giddy_tpu": 1, "giddy_tpu.api": 1, "flax.linen": 1,
            "giddy_tpu_torch": 1, "giddy_tpu_torch.api": 1, "jaxtyping": 1, "giddy_tpux": 1}
    assert guard.loaded(mods) == ["flax.linen", "giddy_tpu", "giddy_tpu.api", "jax", "jax.numpy", "jaxlib.xla"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import cells, harness, guard; "
            f"r, c = harness.run(cells.resolve('.', '{QUERY[0]}'), 3, 0.2, False, 'cpu', rows=40000); "
            "import benchmark.control; assert r['correct'], r; print(guard.loaded())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


# A loop that no mix used before: one predicate, counted again and again.
REPEAT = """
import time

from benchmark import reference
from benchmark.runners import Window, launched, sync


class Job:
    def __init__(self, residents, sut, device):
        self.res, self.sut, self.device = residents[0], sut, device

    def window(self, seconds, trace, keep=True):
        w, t0 = Window(), time.perf_counter()
        while not w.attempted or time.perf_counter() - t0 < seconds:
            w.attempted += 1
            before = self.sut.launches()
            bm = self.sut.predicate(self.res, "le", 30)
            launched(self.sut, w, before)
            w.answers.append(self.sut.count(bm, self.res.n))
        sync(self.device)
        w.seconds = time.perf_counter() - t0
        return w


def prepare(cell, residents, seed, seconds, sut, device):
    return Job(residents, sut, device)


def check(columns, w):
    want = int(reference.predicate_mask(next(iter(columns.values())), "le", 30).sum())
    return [("wrong_counts", sum(a != want for a in w.answers), 0)]
"""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, the loop that drives it and a metric added
    as files, with their BENCHMARK.json entries, run without an edit to any
    file there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("results", "__pycache__"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "tpch-sf100-lineitem-q6.json").read_text())
    cfg["name"] = "tpch-sf1-lineitem-qty"
    cfg["rows"] = 60000
    cfg["columns"] = [c for c in cfg["columns"] if c["name"] == "l_quantity"]
    (b / "configs" / "tpch-sf1-lineitem-qty.json").write_text(json.dumps(cfg))
    (b / "traffic" / "small-qty.json").write_text(json.dumps({
        "runner": "repeat", "clients": 1, "loop": "closed", "why": "one predicate, again and again"}))
    (b / "runners" / "repeat.py").write_text(REPEAT)
    (b / "metrics" / "answered.py").write_text("def read(ctx):\n    return float(len(ctx.window.answers))\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": cfg["name"], "source": "test", "file": "benchmark/configs/tpch-sf1-lineitem-qty.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tpch-sf1-lineitem-qty.small-qty", "config": cfg["name"], "traffic": "small-qty",
                           "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "answered", "unit": "queries", "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": ["tpch-sf1-lineitem-qty.small-qty"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import sys, json; sys.path.insert(0, '.'); from benchmark import cells, harness; "
            "r, c = harness.run(cells.resolve('.', 'tpch-sf1-lineitem-qty.small-qty'), 3, 0.3, False, 'cpu'); "
            "print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["answered"]["value"] > 0 and "queries_per_s" not in r["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """The command itself, a short window, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(SEED),
                        "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
