"""scripts/multihost_bench_torch.py on the CPU: as one process (its main,
in this process) and as two torch.distributed (gloo) ranks on 127.0.0.1
(two subprocesses). Host 0 prints the reference script's JSON line, with
the reference's keys; the other host prints nothing."""

import ast
import importlib.util
import json
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "multihost_bench_torch.py"
SCHEMES = "nbit,for,delta,dict,rle"


def reference_keys() -> tuple[set, set]:
    """The keys of scripts/multihost_bench.py's line and of each scheme's
    record in it, read from its source."""
    tree = ast.parse((ROOT / "scripts" / "multihost_bench.py").read_text())
    dicts = [{k.value for k in node.keys} for node in ast.walk(tree)
             if isinstance(node, ast.Dict) and node.keys and all(isinstance(k, ast.Constant) for k in node.keys)]
    return next(d for d in dicts if "num_hosts" in d), next(d for d in dicts if "decode_GBps_slice" in d)


def check_line(line: dict, hosts: int, devices: int, n: int) -> None:
    want_line, want_record = reference_keys()
    assert set(line) == want_line
    assert (line["num_hosts"], line["devices"], line["n"]) == (hosts, devices, n)
    assert list(line["schemes"]) == SCHEMES.split(",")
    for scheme, r in line["schemes"].items():
        assert set(r) == want_record, scheme
        assert r["time_s"] > 0 and r["decode_GBps_slice"] == pytest.approx(r["decode_GBps_per_chip"] * devices)


def test_one_process(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("multihost_bench_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mod.main(["--n", "12", "--iters", "2", "--device", "cpu", "--out", str(tmp_path / "line.json")])
    finally:
        torch.set_num_threads(before)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    check_line(json.loads(out[0]), 1, 1, 4096)
    assert (tmp_path / "line.json").read_text() == out[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(SCRIPT), "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2",
                               "--host-id", str(rank), "--n", "12", "--iters", "2", "--device", "cpu"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {err[-2000:]}"
    assert outs[1][0] == ""
    lines = outs[0][0].splitlines()
    assert len(lines) == 1
    check_line(json.loads(lines[0]), 2, 2, 4096)


def test_script_imports_no_jax():
    """Every import of the script, its main's included: torch, NumPy, the
    standard library and giddy_tpu_torch."""
    tree = ast.parse(SCRIPT.read_text())
    roots = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}
    assert "giddy_tpu_torch" in roots and not roots & {"jax", "jaxlib", "giddy_tpu"}
