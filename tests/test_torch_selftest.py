"""giddy_tpu_torch.selftest on the CPU: ``run_selftest(2·GROUP + 999,
device="cpu")`` passes every core scheme and every check, and its names
are the reference's (giddy_tpu/selftest.py) but ``xor_mxu``, a TPU MXU
path the port has no counterpart of. The reference's names are read from
its source, since running it would trace every scheme in interpret mode."""

import importlib
import inspect
import json
import pathlib
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


def test_cpu_report_has_no_traffic_ok(report):
    """On the CPU the audit measures no ratios, so, as in the reference's
    interpreted run, the traffic gate leaves no key."""
    assert "traffic_ok" not in report


def test_traffic_cap_and_message_are_the_reference(capsys, monkeypatch):
    assert selftest.TRAFFIC_CAP == jselftest.TRAFFIC_CAP == 1.15
    message = 'f"[selftest] traffic over {TRAFFIC_CAP}x SoL bytes: {bad}"'
    assert message in inspect.getsource(jselftest.run_selftest)
    assert message in inspect.getsource(selftest.run_selftest)


def fake_audit(over: dict):
    """A traffic_audit that reads ``over[scheme]`` (else 1.0) as each
    column's traffic_vs_sol, as the card's audit would report it."""
    def audit(col, device="cuda"):
        r = over.get(col.scheme, 1.0)
        return {"temp_bytes": 0, "ratio": r, "sol_ratio": r}

    return audit


@pytest.mark.parametrize("over", [{}, {"dzbv": 1.1501}, {"rle": 2.0, "delta": 1.16}, {"nbit": 1.15}],
                         ids=["none", "dzbv", "two", "at-the-cap"])
def test_traffic_gate(capsys, monkeypatch, over):
    """With an audit that measures ratios, traffic_ok is False exactly when
    a core scheme reads over TRAFFIC_CAP, stderr names those schemes, and
    pass is still decided by exactness alone."""
    from giddy_tpu_torch import roofline

    monkeypatch.setattr(roofline, "traffic_audit", fake_audit(over))
    monkeypatch.setattr(selftest, "CHECKS", ())
    r = selftest.run_selftest(GROUP + 1, device="cpu")
    bad = {s: over[s] for s in selftest.SCHEMES if over.get(s, 1.0) > selftest.TRAFFIC_CAP}
    err = capsys.readouterr().err
    assert r["pass"] is True and r["traffic_ok"] is (not bad)
    assert all(r["schemes"][s]["traffic_vs_sol"] == over.get(s, 1.0) for s in selftest.SCHEMES)
    lines = [x for x in err.splitlines() if "traffic over" in x]
    if bad:
        assert lines == [f"[selftest] traffic over 1.15x SoL bytes: {bad}"]
    else:
        assert lines == []


def test_traffic_gate_leaves_pass_to_exactness(monkeypatch):
    """A failing check fails the run while the traffic is within the cap,
    and no key appears without the audit."""
    from giddy_tpu_torch import roofline

    def broken(n, rng, device):
        raise AssertionError("planted")

    monkeypatch.setattr(roofline, "traffic_audit", fake_audit({}))
    monkeypatch.setattr(selftest, "CHECKS", (("wide", broken),))
    r = selftest.run_selftest(GROUP + 1, device="cpu")
    assert r["pass"] is False and r["traffic_ok"] is True
    assert "traffic_ok" not in selftest.run_selftest(GROUP + 1, device="cpu", audit=False)


@pytest.mark.parametrize("traffic_ok", [True, False, None], ids=["ok", "over", "absent"])
def test_chip_smoke_fails_unless_the_traffic_gate_passed(capsys, monkeypatch, traffic_ok):
    """chip_smoke.py's selftest phase prints each core scheme's audit beside
    the cap and raises (the script then exits non-zero) when the report's
    traffic_ok is False or missing."""
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parent.parent))
    smoke = importlib.import_module("chip_smoke")
    sol = 1.0 if traffic_ok else 1.2
    report = {"pass": True, "schemes": {s: {"temp_bytes": 0, "traffic_vs_ideal": sol, "traffic_vs_sol": sol}
                                        for s in selftest.SCHEMES}}
    if traffic_ok is not None:
        report["traffic_ok"] = traffic_ok
    monkeypatch.setattr(selftest, "run_selftest", lambda n, device: report)
    monkeypatch.setattr(smoke, "SELFTEST", [])

    def drive(label, what, fn, expect=()):
        assert fn(), label

    if traffic_ok:
        smoke.selftest_main_path(drive)
    else:
        with pytest.raises(RuntimeError, match="traffic gate"):
            smoke.selftest_main_path(drive)
    audit = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[audit] ")]
    assert len(audit) == len(selftest.SCHEMES) + 1 and all("1.15" in x for x in audit)
