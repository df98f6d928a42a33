"""One file a metric, found by the metric's name in BENCHMARK.json:
``metrics/<name>.py``, or, where there is none, ``metrics/<quantity>.py``
for the quantity that the name holds before its first dot (one reader for
``device_idle_pct.decode`` and ``device_idle_pct.query``). Each has
``read(ctx)`` (a Context) -> a number, or None where it finds nothing to
read; the harness then leaves the metric out of the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
import re

_DIR = pathlib.Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass
class Context:
    """What a metric reads: the set-up's seconds, the measured window
    (runners.Window), the resident columns' sizes, the trace of a traced
    run, and the window that host-clock metrics read (in a traced run an
    untraced one run before it, so the profiler's host cost stays out)."""

    setup_s: float
    window: object
    columns: dict  # name -> (stream_bytes, n, itemsize)
    trace: object = None  # tracing.Trace
    clock: object = None  # runners.Window


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    if not _NAME.fullmatch(name):
        raise ValueError(f"bad metric name {name!r}")
    for stem in (name, name.split(".", 1)[0]):
        path = _DIR / f"{stem}.py"
        if path.is_file():
            break
    else:
        raise FileNotFoundError(f"no reader for metric {name!r} in {_DIR}")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
