"""Host ranges of the port's own work, on the profiler's clock.

``span(name)`` (or ``span(name, what)``, recorded as ``giddy.<name>:<what>``)
marks a stretch of the port's host work: a decoder's build, a decode call,
its kernel launch, the streams' prep and upload. It records only while a
torch profiler records: the range then lands in the profiler's trace beside
the card's kernels and the CUDA runtime calls, on one timeline, and is
written out with it (``torch.profiler``'s own export, the CLI's ``decode
--trace DIR``). At every other time a site costs one C call and hands back
one shared no-op context; the qualified name is built only when it records.
A span's parent is the span that encloses it on the calling thread.

``giddy.wait:<what>`` marks a call by which the port blocks the host on the
card (``wait:upload``, a blocking ``.to(device)`` from pageable memory). The
list of spans, and what reads each one, is in PERF.md §3.
"""

from __future__ import annotations

import contextlib

import torch

_recording = torch._C._autograd._profiler_enabled
# torch's own light range (a CPU op in the trace); record_function's user
# annotation where this torch lacks it
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function
OFF = contextlib.nullcontext()


def span(name: str, what: str | None = None):
    """A context that records ``giddy.<name>[:<what>]`` while a profiler
    records, else :data:`OFF`."""
    if not _recording():
        return OFF
    return _range(f"giddy.{name}" if what is None else f"giddy.{name}:{what}")
