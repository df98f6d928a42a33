"""The benchmark of giddy_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (configs/<name>.json: the
table, its columns and the scheme each is stored in) and a traffic mix
(traffic/<mix>.json, driven by the loop its ``runner`` names). The run
draws the table on the card from the seed, loads it into the program,
warms up, measures for ``--seconds`` and then checks what the window
produced against the plain reference. With ``--trace 0`` it reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiler trace of the window (and the host clock's from an
untraced window before it). The port builds its kernels and host codec
once a checkout, into giddy_tpu_torch/_build/.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each compared number with its limit);
the last lines of standard error repeat the compared numbers. Without a
CUDA card, or with fewer than the cell needs, it exits with code 2 and
prints no result; a run that loaded JAX or the JAX package exits with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    marks = {"main": time.perf_counter() - T0}
    import torch

    marks["torch"] = time.perf_counter() - T0
    from benchmark import cells, guard

    cell = cells.resolve(ROOT, args.workload)
    marks["resolve"] = time.perf_counter() - T0
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); torch sees {found}", file=sys.stderr)
        return 2
    from benchmark import harness

    result, checks = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    phases = {**marks, **result.pop("setup_phases")}
    power = _power_limit()
    found = guard.loaded()
    if found:
        print(f"[bench] forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                        **result["device"], "power_limit": power}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(result))
    print(f"[bench] set-up seconds: {json.dumps(phases)}", file=sys.stderr)
    print(f"[bench] {args.workload} seed {args.seed}: correct {result['correct']}, card "
          f"{result['device']['kind']}, power limit {power}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"[bench] check {name} {value} limit {limit}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
