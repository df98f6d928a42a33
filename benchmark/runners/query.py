"""Queries: each a conjunction of predicates (``where``) on resident
columns, whose bitmaps are ANDed in order and counted; the count reaches
the host before the next query starts (a closed loop, one client).

The mix's ``templates`` take turns. A template's ``params`` are drawn a
query from the seed: ``{"draw": "int", "low", "high"}`` (inclusive) or
``{"draw": "window", "unit": "year"|"month"|"week", "first", "last"}``, a
whole calendar window inside the range, whose fields ``first``, ``last``
and ``end`` (the day after) a predicate names as ``date.first``. A value
is an integer, a parameter, or a parameter plus or minus an integer
(``discount-1``); dates take the encoding of the column they are compared
with. The window starts no query after ``seconds`` and ends when the last
one started has answered. The comparison checks every query's count.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import time

import numpy as np

from .. import dates, datagen, reference
from . import Window, launched, spans, sync

_VALUE = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)(?:\.(first|last|end))?(?:([+-])(\d+))?")


@dataclasses.dataclass(frozen=True)
class Predicate:
    column: str
    op: str
    value: int | None = None
    low: int | None = None
    high: int | None = None


@dataclasses.dataclass(frozen=True)
class Query:
    template: str
    where: tuple[Predicate, ...]


def _drawer(spec: dict):
    """A function of the rng that draws one value of parameter ``spec``."""
    if spec["draw"] == "int":
        return lambda rng: int(rng.integers(spec["low"], spec["high"] + 1))
    if spec["draw"] == "window":
        spans_ = dates.windows(spec["unit"], spec["first"], spec["last"])

        def window(rng):
            first, last = spans_[int(rng.integers(len(spans_)))]
            return {"first": first, "last": last, "end": last + 1}
        return window
    raise ValueError(f"unknown draw {spec['draw']!r}")


def _value(expr, params: dict, encoding: str | None) -> int:
    if isinstance(expr, int):
        return expr
    m = _VALUE.fullmatch(expr)
    if not m or m.group(1) not in params:
        raise ValueError(f"bad value {expr!r}")
    v = params[m.group(1)]
    is_date = isinstance(v, dict)
    if is_date != (m.group(2) is not None):
        raise ValueError(f"{expr!r}: a window is named with .first, .last or .end, and only a window")
    v = v[m.group(2)] if is_date else v
    if m.group(3):
        v = v + int(m.group(4)) if m.group(3) == "+" else v - int(m.group(4))
    if is_date:
        if encoding is None:
            raise ValueError(f"{expr!r} is a date, compared with a column that stores none")
        v = dates.encode(v, encoding)
    return int(v)


def queries(mix: dict, encodings: dict[str, str | None], seed: int):
    """The mix's queries drawn from ``seed``, its templates in turn, without
    end. ``encodings`` maps each resident column to its date encoding (None
    for a column of plain integers)."""
    rng = np.random.default_rng(int(seed) % 2**64)
    templates = [(t, {k: _drawer(spec) for k, spec in t.get("params", {}).items()}) for t in mix["templates"]]
    for i in itertools.count():
        t, drawers = templates[i % len(templates)]
        params = {k: draw(rng) for k, draw in drawers.items()}
        where = []
        for p in t["where"]:
            enc = encodings[p["column"]]
            if p["op"] == "between":
                where.append(Predicate(p["column"], "between", low=_value(p["low"], params, enc),
                                       high=_value(p["high"], params, enc)))
            else:
                where.append(Predicate(p["column"], p["op"], value=_value(p["value"], params, enc)))
        yield Query(t["name"], tuple(where))


def draw_queries(mix: dict, encodings: dict, seed: int, count: int) -> list[Query]:
    """The first ``count`` of :func:`queries`."""
    return list(itertools.islice(queries(mix, encodings, seed), count))


def answer(query: Query, by_name: dict, sut, span, w: Window | None = None) -> int:
    """One query through the system under test: each predicate's bitmap,
    ANDed in order, counted on the host. With ``w``, each predicate call
    is counted with whether it launched a port kernel."""
    bitmap = None
    for p in query.where:
        res = by_name[p.column]
        kind = "between:" if p.op == "between" else "filter:"
        before = sut.launches()
        with span(kind + p.column):
            bm = sut.predicate(res, p.op, p.value, p.low, p.high)
        if w is not None:
            launched(sut, w, before)
        if bitmap is None:
            bitmap = bm
        else:
            with span("and"):
                bitmap = sut.bitmap_and(bitmap, bm)
    n = by_name[query.where[0].column].n
    with span("count"):
        return sut.count(bitmap, n)


class Job:
    def __init__(self, residents, sut, device, stream):
        self.by_name = {r.name: r for r in residents}
        self.sut, self.device, self.stream = sut, device, stream

    def window(self, seconds: float, trace: bool, keep: bool = True) -> Window:
        """Queries of the stream one after another for ``seconds``, each
        timed from its first call to its count on the host."""
        span = spans(trace)
        w = Window()
        t0 = time.perf_counter()
        for q in self.stream:
            if w.attempted and time.perf_counter() - t0 >= seconds:
                break
            w.attempted += 1
            a = time.perf_counter()
            try:
                got = answer(q, self.by_name, self.sut, span, w)
            except Exception as e:  # noqa: BLE001 - a failed query is counted and reported, the window goes on
                if w.failure(e):
                    break
                continue
            w.latencies_s.append(time.perf_counter() - a)
            w.queries.append(q)
            w.answers.append(got)
        sync(self.device)
        w.seconds = time.perf_counter() - t0
        return w


def prepare(cell, residents, seed: int, seconds: float, sut, device) -> Job:
    """Warm up on queries drawn from seed + 1 (every template twice), then
    the window's stream from the seed."""
    encodings = {s["name"]: s.get("date") for s in datagen.resident(cell.config)}
    by_name = {r.name: r for r in residents}
    for q in draw_queries(cell.mix, encodings, int(seed) + 1, 2 * len(cell.mix["templates"])):
        answer(q, by_name, sut, spans(False))
    sync(device)
    return Job(residents, sut, device, queries(cell.mix, encodings, seed))


def check(columns: dict, w: Window) -> list:
    """Queries whose count differs from the reference's."""
    want = reference.counts(columns, w.queries)
    return [("wrong_counts", sum(int(a != b) for a, b in zip(w.answers, want)), 0)]
