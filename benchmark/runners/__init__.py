"""One file a loop: ``runners/<name>.py``, named by a mix's ``runner`` key.

A mix (``traffic/<mix>.json``) is data; its runner is the code that drives
the system under test with it. A runner module has

- ``prepare(cell, residents, seed, seconds, sut, device) -> job``: draws
  what the window needs from the seed and warms up every call the window
  makes (set-up). ``job.window(seconds, trace, keep) -> Window`` runs the
  closed loop for ``seconds``; ``keep`` keeps what the comparison of this
  window needs.
- ``check(columns, window) -> [(name, value, limit), ...]``: the numbers
  that judge one window against the plain reference, worked out from the
  generated ``columns`` once the program's state is gone.

``sut`` is the system under test (system.py, or the control put in its
place). A new loop is a new file here; a new mix of an existing loop is a
new data file under ``traffic/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import re

import torch

_NAME = re.compile(r"[A-Za-z0-9_]+")


def load(name: str):
    """The runner module ``name`` (a file of this package)."""
    if not isinstance(name, str) or not _NAME.fullmatch(name) or name.startswith("_"):
        raise ValueError(f"bad runner name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


@dataclasses.dataclass
class Window:
    """What one measured window did: its length, the work it started and
    finished, and what the comparison needs afterwards. A runner fills the
    fields its loop has; a new loop may subclass it."""

    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    # program calls that should launch a kernel of the port and launched none
    unlaunched: int = 0
    errors: list = dataclasses.field(default_factory=list)
    # decode
    rounds: int = 0
    decoded_bytes: int = 0
    issue_s: list = dataclasses.field(default_factory=list)
    kept_round: int | None = None
    kept: list | None = None
    # query
    queries: list = dataclasses.field(default_factory=list)
    answers: list = dataclasses.field(default_factory=list)
    latencies_s: list = dataclasses.field(default_factory=list)

    def failure(self, e: Exception) -> bool:
        """Count a failed unit of work; True once the window should stop."""
        self.failed += 1
        self.errors.append(repr(e))
        return self.failed >= 10


def spans(trace: bool):
    """``span(name)``: a profiler range around one program call when the
    run is traced, nothing otherwise."""
    if not trace:
        return lambda name: contextlib.nullcontext()
    return lambda name: torch.profiler.record_function("bench." + name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launched(sut, w: Window, before: int) -> None:
    """Count a program call that should have launched a port kernel and
    did not (the port's launch counter is still at ``before``)."""
    if sut.launches() == before:
        w.unlaunched += 1
