"""A cell of BENCHMARK.json, resolved to its files by name.

A cell names a configuration and a traffic mix. The configuration's entry
gives its file (``configs/<name>.json``); the mix is
``traffic/<traffic>.json``, whose ``runner`` key names the loop that drives
it (``runners/<runner>.py``); each metric is read by a file of
``metrics/``. A cell
reports every end-to-end metric whose ``workloads`` list it (or that has
no such list) and, traced, every per-layer metric whose ``workloads`` list
it (or, without a list, whose ``moves`` metric it reports).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

from . import runners

BENCH = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: str
    mix: dict
    runner: object  # the module runners/<mix's runner>.py
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json."""
    manifest = json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((pathlib.Path(root) / configs[w["config"]]["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    runner = runners.load(mix.get("runner"))
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, w["traffic"], mix, runner, e2e, per_layer)
