"""giddy_tpu_torch.selftest on the CPU: ``run_selftest(2·GROUP + 999,
device="cpu")`` passes every core scheme and every check, and its names
are the reference's (giddy_tpu/selftest.py) but ``xor_mxu``, a TPU MXU
path the port has no counterpart of. The reference's names are read from
its source, since running it would trace every scheme in interpret mode."""

import inspect
import json
import re

import numpy as np
import pytest
import torch

from giddy_tpu import selftest as jselftest
from giddy_tpu_torch import selftest
from giddy_tpu_torch.util import GROUP


@pytest.fixture(scope="module")
def report():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return selftest.run_selftest(2 * GROUP + 999, device="cpu")
    finally:
        torch.set_num_threads(before)


def reference_checks() -> list[str]:
    return re.findall(r'\("(\w+)", _check_\w+\)', inspect.getsource(jselftest.run_selftest))


def test_every_scheme_and_check_passes(report):
    failed = {k: v.get("error") for k, v in report["schemes"].items() if not v["exact"]}
    assert report["pass"] and not failed, failed
    assert report["device"] == "cpu" and report["n"] == 2 * GROUP + 999 and "uncovered_schemes" not in report
    json.dumps(report)  # the one JSON line main prints


def test_names_are_the_reference_minus_xor_mxu(report):
    want = reference_checks()
    assert "xor_mxu" in want and len(want) == 15
    assert [name for name, _ in selftest.CHECKS] == [c for c in want if c != "xor_mxu"]
    assert list(report["schemes"]) == list(jselftest.SCHEMES) + [c for c in want if c != "xor_mxu"]


def test_every_core_scheme_is_audited(report):
    """The reference's audit keys on every core scheme; on the CPU torch
    keeps no allocator statistics, so the values are None (the card's are
    held in tests/test_torch_cuda.py)."""
    source = inspect.getsource(jselftest.run_selftest)
    keys = ("temp_bytes", "traffic_vs_ideal", "traffic_vs_sol")
    assert all(f'entry["{k}"]' in source for k in keys)
    for scheme in selftest.SCHEMES:
        assert {k: report["schemes"][scheme][k] for k in keys} == dict.fromkeys(keys), scheme


def test_audit_can_be_left_out(monkeypatch):
    monkeypatch.setattr(selftest, "CHECKS", ())
    r = selftest.run_selftest(GROUP + 1, device="cpu", audit=False)
    assert r["pass"] and all("temp_bytes" not in r["schemes"][s] for s in selftest.SCHEMES)


def test_a_failing_check_fails_the_run(monkeypatch):
    """A check that raises is recorded with its error and the run fails;
    nothing turns it into a pass."""
    def broken(n, rng, device):
        raise AssertionError("planted")

    monkeypatch.setattr(selftest, "CHECKS", (("wide", broken),))
    r = selftest.run_selftest(GROUP + 1, device="cpu")
    assert r["pass"] is False and all(r["schemes"][s]["exact"] for s in selftest.SCHEMES)
    assert r["schemes"]["wide"]["exact"] is False and "planted" in r["schemes"]["wide"]["error"]


def test_main_prints_one_json_line(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(selftest, "CHECKS", selftest.CHECKS[:1])
    code = selftest.main(["--n", str(GROUP + 5), "--device", "cpu", "--out", str(tmp_path / "s.json")])
    line = capsys.readouterr().out.strip()
    assert code == 0 and "\n" not in line and json.loads(line)["pass"] is True
    assert json.loads((tmp_path / "s.json").read_text()) == json.loads(line)
    assert np.isfinite(json.loads(line)["schemes"]["rle"]["decode_s"])
