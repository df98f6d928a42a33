"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

Set-up draws the configuration's table on the device from the seed, hands
each resident column to the system under test (system.load), and lets the
mix's runner (runners/<runner>.py) draw what the window needs and warm up
every call the window makes. The window runs the mix for ``seconds``; a
traced run runs it under the profiler, after an untraced window of at most
CLOCK_SECONDS from which the per-layer metrics of the host clock are read.
Then the device's peak memory is read, the program's state is freed, the
table is drawn again from the seed, and the plain reference
(reference.py) judges what the windows produced through the runner's
``check``; on a CUDA device every program call must also have launched a
kernel of the port (the port's own launch counters), so that an answer
served from a cache, with no scan behind it, reads not correct.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from . import datagen, guard, metrics, system, tracing

LIMITS = {"failed": 0, "unlaunched_calls": 0}
CLOCK_SECONDS = 5.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _per_unit_ms(w) -> float:
    units = w.rounds or len(w.answers)
    return 1e3 * w.seconds / units if units else float("nan")


def _issue_us(w) -> float:
    return 1e6 * sum(w.issue_s) / len(w.issue_s) if w.issue_s else float("nan")


def run(cell, seed: int, seconds: float, trace: bool, device, *, rows: int | None = None,
        t0: float | None = None, sut=system, count_launches: bool | None = None) -> tuple[dict, list]:
    """Run ``cell`` once. Returns the result line (without ``device``'s
    name and count, which the caller adds) and the compared numbers as
    (name, value, limit). ``rows`` (tests) draws a smaller table and skips
    the check of the encoders' parameters; ``sut`` is the system under
    test (the control puts itself in its place); ``count_launches``
    (default: on a CUDA device) compares the calls that launched no port
    kernel."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    count_launches = device.type == "cuda" if count_launches is None else count_launches
    specs = datagen.resident(cell.config)
    phases = {"start": time.perf_counter() - t0}
    columns = datagen.build(cell.config, seed, device, rows)
    _sync(device)
    phases["draw"] = time.perf_counter() - t0 - phases["start"]
    residents = sut.load(columns, specs, device, check_params=rows is None, phases=phases)
    del columns
    t_warm = time.perf_counter()
    sizes = {r.name: (r.stream_bytes(), r.n, r.itemsize) for r in residents}
    job = cell.runner.prepare(cell, residents, seed, seconds, sut, device)
    clock_first = trace and any(m["source"] == "host_clock" for m in cell.per_layer)
    _sync(device)
    guard.check()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    phases["warm"] = time.perf_counter() - t_warm

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    windows = []
    clock = None
    if clock_first:  # before the profiler has ever started in this process
        clock = job.window(min(seconds, CLOCK_SECONDS), False, keep=False)
        windows.append(clock)
    if trace:
        with tracing.profiler():  # the profiler's own start-up, once, outside the window
            torch.zeros(1, device=device).add_(1)
            _sync(device)
        with tracing.profiler() as prof:
            with torch.profiler.record_function(tracing.WINDOW):
                w = job.window(seconds, True)
            _sync(device)
        traced = tracing.read(prof)
        del prof
    else:
        w = clock = job.window(seconds, False)
        traced = None
    windows.append(w)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.unfreeze()
    for x in windows:
        for err in x.errors:
            print(f"[bench] a call failed in the window: {err}", file=sys.stderr)
    for x, how in ((clock, "untraced"), (w, "traced")) if trace else ((w, "untraced"),):
        if x is not None:
            print(f"[bench] {how} window: a unit of work took {_per_unit_ms(x)} ms, a decode call issued in "
                  f"{_issue_us(x)} us", file=sys.stderr)

    ctx = metrics.Context(setup_s, w, sizes, traced, clock)
    chosen = cell.per_layer if trace else cell.end_to_end
    values = {m["name"]: metrics.reader(m["name"])(ctx) for m in chosen}
    result = {
        "setup_phases": phases,
        "correct": False,
        "attempted": sum(x.attempted for x in windows),
        "failed": sum(x.failed for x in windows),
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in chosen if values[m["name"]] is not None},
        "device": {"memory_peak_bytes": int(peak)},
    }
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_seconds()
        result["device"]["window_s"] = traced.seconds
        result["breakdown"] = tracing.breakdown(traced)
    del traced, ctx, clock, w

    # the comparison, once the program's state is gone
    del residents, job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cell, seed, device, rows, windows, count_launches)
    result["correct"] = bool(windows[-1].attempted) and all(v <= lim for _, v, lim in checks)
    guard.check()
    return result, checks


def compare(cell, seed: int, device, rows, windows: list, count_launches: bool) -> list:
    """The compared numbers of a run's windows, each with its limit: the
    calls that failed, those that launched no port kernel, and the
    runner's own (values or counts that differ from the reference's)."""
    checks = [("failed", sum(w.failed for w in windows), LIMITS["failed"])]
    if count_launches:
        checks.append(("unlaunched_calls", sum(w.unlaunched for w in windows), LIMITS["unlaunched_calls"]))
    columns = datagen.build(cell.config, seed, device, rows)
    totals: dict = {}
    for w in windows:
        for name, value, limit in cell.runner.check(columns, w):
            totals[name] = (totals.get(name, (0, limit))[0] + value, limit)
    return checks + [(name, value, limit) for name, (value, limit) in totals.items()]
