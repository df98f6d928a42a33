"""bench_torch.py against bench.py on the CPU.

Every bench kind (each core scheme, ``rle_dense``, ``xordelta_narrow``,
the mixed set and the narrow set) prepares the column that bench.py's own
code prepares from the same draw: the same container bytes and ratio, for
a fresh ``default_rng(0)`` as each ``--one`` process has and for main's
``--no-subproc`` order, which threads one rng through every kind. The
reference runs in the worker's reference process (test_torch_inputs.JAX),
once per run, with its decoder, upload and timer stubbed, so that no
interpret-mode decode runs. Each prepared ``run()`` is held bit for bit to
the port's ``decode_ref``. The records, the JSON line and the floor file
have the reference's keys and values; the sweep runs shards of one CPU
device, one fresh process a point; ``--scan-ab`` is refused."""

import argparse
import ast
import json
import pathlib
import subprocess

import numpy as np
import pytest
import torch

import bench_torch
from giddy_tpu_torch import api
from giddy_tpu_torch.format import container_bytes
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX, once_per_run

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 2 * GROUP
KINDS = [*bench_torch.ALL, "rle_dense", "xordelta_narrow"]
# set kind -> (the port's prepare function, the reference's bench function)
SETS = {"mixed": ("prepare_mixed", "bench_mixed"), "narrow": ("prepare_narrow", "bench_narrow")}
# main's --no-subproc order with --schemes all: every scheme, then the sets
ORDER = [*bench_torch.ALL, *SETS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reference_bench():
    """bench.py as a module (it imports jax and giddy_tpu: the reference
    process only)."""
    import importlib.util
    import sys

    mod = sys.modules.get("_reference_bench")
    if mod is None:
        spec = importlib.util.spec_from_file_location("_reference_bench", ROOT / "bench.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["_reference_bench"] = mod
    return mod


def reference_columns(n: int) -> tuple[dict, dict]:
    """(fresh, threaded): kind -> [(container bytes, ratio)] of each column
    that bench.py's prepare_scheme / bench_mixed / bench_narrow encode,
    from a fresh default_rng(0) a kind and from one rng over ORDER."""
    from unittest import mock

    import giddy_tpu
    from giddy_tpu.format import container_bytes as ref_container_bytes

    bench = reference_bench()
    seen = []

    def decoder(col, *store):
        seen.append(col)
        return lambda streams: None

    def draw(kinds, rng) -> dict:
        out = {}
        for kind in kinds:
            seen.clear()
            if kind in SETS:
                getattr(bench, SETS[kind][1])(n, 1, rng)
            else:
                bench.prepare_scheme(kind, n, rng)
            out[kind] = [(ref_container_bytes([c]), c.ratio) for c in seen]
        return out

    with mock.patch.object(giddy_tpu, "get_decoder", decoder), \
            mock.patch.object(giddy_tpu.api, "device_streams", lambda col: col.streams), \
            mock.patch.object(bench, "_median_time", lambda run, iters: 1.0):
        fresh = {kind: draw([kind], np.random.default_rng(0))[kind] for kind in [*KINDS, *SETS]}
        return fresh, draw(ORDER, np.random.default_rng(0))


def reference_floor(details: list, outdir: str) -> list:
    """bench.py's _regression_floor over ``details`` in turn: each one's
    floor_drops and the floor file after it."""
    bench = reference_bench()
    out = []
    for detail in details:
        bench._regression_floor(detail, pathlib.Path(outdir))
        out.append((detail.get("floor_drops"), (pathlib.Path(outdir) / "bench_floor.json").read_text()))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return once_per_run(tmp_path_factory, "bench-reference", lambda root: JAX(reference_columns, N))[1]


def prepared(kind: str, rng):
    """The port's columns of a kind and a run() that gives their outputs."""
    if kind in SETS:
        return getattr(bench_torch, SETS[kind][0])(N, rng, "cpu")
    col, run = bench_torch.prepare_scheme(kind, N, rng, "cpu")
    return [col], lambda: [run()]


def records(cols: list) -> list:
    return [(container_bytes([c]), c.ratio) for c in cols]


@pytest.mark.parametrize("kind", [*KINDS, *SETS])
def test_prepared_columns_are_the_references(reference, kind):
    cols, run = prepared(kind, np.random.default_rng(0))
    assert records(cols) == reference[0][kind]
    outs = run()
    assert len(outs) == len(cols)
    for col, u in zip(cols, outs):
        got, want = u.numpy()[: col.n], api.decode_ref(col)
        assert got.dtype.itemsize == want.dtype.itemsize and got.tobytes() == want.tobytes(), col.name


def test_no_subproc_threads_one_rng_as_the_reference(reference):
    rng = np.random.default_rng(0)
    for kind in ORDER:
        assert records(prepared(kind, rng)[0]) == reference[1][kind], kind


def reference_keys(function: str) -> list[str]:
    """The constant keys of the dict literal that bench.py's ``function``
    returns."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == function)
    ret = next(node for node in ast.walk(fn) if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict))
    return [k.value for k in ret.value.keys]


def line_keys() -> set[str]:
    """The keys bench.py's main can put in its JSON line."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "line" for t in node.targets):
            keys.update(k.value for k in node.value.keys)
        elif isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and node.value.id == "line":
            keys.add(node.slice.value)
    return keys


def test_line_keys_reads_the_reference_main():
    assert line_keys() == {"metric", "value", "unit", "timing_suspect", "vs_baseline", "selftest_pass"}


RECORDS = {
    "time_prepared": lambda rng: bench_torch.time_prepared(*bench_torch.prepare_scheme("nbit", N, rng, "cpu"), "nbit",
                                                           1, "cpu"),
    "bench_mixed": lambda rng: bench_torch.bench_mixed(N, 1, rng, "cpu"),
    "bench_narrow": lambda rng: bench_torch.bench_narrow(N, 1, rng, "cpu"),
    "bench_dist": lambda rng: bench_torch.bench_dist(N, 1, rng, "cpu"),
}


@pytest.mark.parametrize("function", list(RECORDS))
def test_records_have_the_reference_keys(function):
    r = RECORDS[function](np.random.default_rng(0))
    assert list(r) == reference_keys(function)
    assert r["decode_GBps"] > 0 and r["time_s"] > 0
    if "device_kind" in r:
        assert r["device_kind"] == "cpu"
    if function == "time_prepared":  # no memory rate is known for the CPU
        assert r["sol_fraction"] is None and r["sol_decode_GBps"] is None
    if function == "bench_dist":
        assert (r["devices"], r["backend"]) == (1, "cpu")


@pytest.mark.parametrize("shards", bench_torch.SWEEP)
def test_bench_dist_decodes_shards_of_one_device(shards):
    r = bench_torch.bench_dist(GROUP, 1, np.random.default_rng(0), "cpu", shards)
    assert (r["devices"], r["backend"]) == (shards, "cpu")
    assert bench_torch.bench_mesh(torch.device("cpu"), shards).devices.tolist() == [torch.device("cpu")] * shards


def bench_line(capsys) -> dict:
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_main_in_process_prints_the_reference_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "RESULTS", tmp_path)
    bench_torch.main(["--n", "12", "--iters", "1", "--trials", "1", "--device", "cpu", "--no-subproc",
                      "--schemes", "all", "--mixed", "--dist", "--no-selftest"])
    line = bench_line(capsys)
    assert set(line) == line_keys() - {"selftest_pass"}
    assert line["metric"] == "decode_GBps_geomean_headline5" and line["unit"] == "GB/s" and line["value"] > 0
    assert line["timing_suspect"] is None and isinstance(line["vs_baseline"], float)
    detail = json.loads((tmp_path / "bench_detail.json").read_text())
    assert detail["device"] == "cpu" and detail["n"] == 4096 and list(detail["schemes"]) == bench_torch.ALL
    assert {"mixed", "narrow", "dist", "ops_roofline"} <= set(detail) and "ops_roofline_error" not in detail
    for scheme, row in detail["ops_roofline"].items():
        assert row["interpreted"] and row["issue_per_elem"] is None and row["budget_issue"] is None, scheme
    assert set(json.loads((tmp_path / "bench_floor.json").read_text())) == set(bench_torch.ALL)


def test_main_spawns_a_fresh_process_a_trial(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "RESULTS", tmp_path)
    bench_torch.main(["--n", "12", "--iters", "1", "--trials", "1", "--device", "cpu", "--schemes", "nbit",
                      "--no-selftest"])
    line = bench_line(capsys)
    assert set(line) == line_keys() - {"selftest_pass"} and line["timing_suspect"] is None
    detail = json.loads((tmp_path / "bench_detail.json").read_text())
    assert detail["device"] == "subproc" and list(detail["schemes"]) == ["nbit"]
    assert list(detail["schemes"]["nbit"]) == reference_keys("time_prepared")
    assert list(detail["narrow"]) == reference_keys("bench_narrow")


def test_a_failed_trial_fails_the_bench():
    args = argparse.Namespace(n=12, iters=1, device="cpu")
    with pytest.raises(RuntimeError, match="bench subprocess nosuch failed"):
        bench_torch._spawn_trials("nosuch", args, 1)


def test_dist_sweep_runs_shards_of_one_device(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_torch, "SWEEP", (1, 2))
    args = argparse.Namespace(n=26, iters=1, trials=1, device="cpu", dist_n=12)
    r = bench_torch._dist_sweep(args, tmp_path)
    assert {k: v["devices"] for k, v in r["mesh_sweep"].items()} == {"1": 1, "2": 2}
    assert r["default_mesh"]["devices"] == 1 and r["n_per_shard"] == 4096
    assert set(r["mesh_efficiency"]) == {"1", "2"} and r["mesh_efficiency"]["1"] == 1.0
    assert "interpret" not in r["note"] and "shard_map" not in r["note"] and "CPU device" in r["note"]
    assert json.loads((tmp_path / "dist_sweep.json").read_text()) == r


def floor_details() -> list:
    """Three runs: a first record, one where delta drops below 0.75x of its
    share, and a two-scheme debug run, which must change nothing."""
    first = {"nbit": 100.0, "for": 80.0, "delta": 40.0, "dict": 60.0, "rle": 90.0}
    second = {**first, "delta": 10.0, "rle": 95.0}
    return [{"schemes": {s: {"decode_GBps": g} for s, g in run.items()}}
            for run in (first, second, {"nbit": 1.0, "for": 2.0})]


def test_regression_floor_is_the_references(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = JAX(reference_floor, floor_details(), str(tmp_path / "ref"))
    got = []
    for detail in floor_details():
        bench_torch._regression_floor(detail, tmp_path / "port")
        got.append((detail.get("floor_drops"), (tmp_path / "port" / "bench_floor.json").read_text()))
    assert got == want
    assert want[0][0] is None and set(want[1][0]) == {"delta"} and want[2] == (None, want[1][1])


@pytest.mark.parametrize("option", ["--scan-ab", "--ab-trials=5"])
def test_scan_ab_is_refused(option, capsys):
    with pytest.raises(SystemExit) as e:
        bench_torch.main([option, "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{option.split('=')[0]} is not ported" in err and "Do not port" in err


@pytest.mark.parametrize("rc", [0, 1])
def test_selftest_runs_the_port_selftest_in_a_fresh_process(tmp_path, monkeypatch, rc):
    calls = []

    def run(cmd, **kwargs):
        calls.append((cmd, kwargs))
        return subprocess.CompletedProcess(cmd, rc, "", "selftest output")

    monkeypatch.setattr(bench_torch.subprocess, "run", run)
    assert bench_torch._run_selftest(tmp_path, torch.device("cpu")) is (rc == 0)
    (cmd, kwargs), = calls
    assert cmd[1:] == ["-m", "giddy_tpu_torch.selftest", "--device", "cpu", "--out", str(tmp_path / "selftest.json")]
    assert kwargs["cwd"] == str(ROOT)
