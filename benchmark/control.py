"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in the 16-bit float
type, driven through a whole run of the harness, which has to come out as
not correct.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--seconds S]

This module stands in for system.py: it holds each generated column as it
is, decodes it through float16 and back, and answers each predicate with
the reference's comparison in float16. Launching no kernel of the port, it
also reads as answering without one. For each seed the command runs the
cell through ``harness.run`` with the control in place (at the cell's size,
a window of ``--seconds``, by default the manifest's ``run_seconds``) and
prints the run's result line with its compared numbers. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import torch

from . import reference

ROOT = pathlib.Path(__file__).resolve().parent.parent
DTYPE = torch.float16


@dataclasses.dataclass
class Held:
    """One generated column, held as it is."""

    name: str
    values: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.values.shape[0])

    @property
    def itemsize(self) -> int:
        return self.values.element_size()

    def decoded_bytes(self) -> int:
        return self.n * self.itemsize

    def stream_bytes(self) -> int:
        return self.decoded_bytes()


def load(columns: dict, specs: list, device, check_params: bool = True, phases: dict | None = None) -> list[Held]:
    return [Held(s["name"], columns[s["name"]]) for s in specs]


def decode(res: Held) -> torch.Tensor:
    return reference.decode(res.values, DTYPE)


def predicate(res: Held, op: str, value=None, low=None, high=None) -> torch.Tensor:
    return reference.predicate_mask(res.values, op, value, low, high, DTYPE)


def bitmap_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def count(mask: torch.Tensor, n: int) -> int:
    return int(torch.count_nonzero(mask[:n]))


def launches() -> int:
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    from benchmark import cells, harness

    if not torch.cuda.is_available():
        print("[control] no CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(ROOT, args.workload)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    sut = sys.modules[__name__]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, checks = harness.run(cell, seed, seconds, False, "cuda", sut=sut)
        result.pop("setup_phases")
        print(json.dumps({"workload": cell.name, "seed": seed, "control": "float16", **result,
                          "checks": {k: {"value": v, "limit": lim} for k, v, lim in checks},
                          "seconds": time.perf_counter() - t, "card": torch.cuda.get_device_name(0)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
