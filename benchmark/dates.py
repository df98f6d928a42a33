"""Calendar arithmetic of the generated data: days since 1970-01-01 (the
unit every date generator draws in) and the flattened ``yyyymmdd`` int32
that SSB and Crystal store."""

from __future__ import annotations

import datetime

import torch

EPOCH = datetime.date(1970, 1, 1)


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date ``YYYY-MM-DD``."""
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def date_of(days: int) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(days))


def yyyymmdd(days: int) -> int:
    d = date_of(days)
    return d.year * 10000 + d.month * 100 + d.day


def encode(days, encoding: str):
    """A day number (an int, or an int32 tensor of them) in a column's date
    encoding: ``days_since_1970`` or ``yyyymmdd``."""
    if encoding == "days_since_1970":
        return days
    if encoding != "yyyymmdd":
        raise ValueError(f"unknown date encoding {encoding!r}")
    if isinstance(days, torch.Tensor):
        lo, hi = int(days.min()), int(days.max())
        table = torch.tensor([yyyymmdd(d) for d in range(lo, hi + 1)], dtype=torch.int32, device=days.device)
        return table[(days - lo).long()]
    return yyyymmdd(days)


def windows(unit: str, first: str, last: str) -> list[tuple[int, int]]:
    """Every whole calendar window of ``unit`` (year, month or week) that
    lies inside [first, last], as (first day, last day). A week is one of
    the 52 seven-day weeks that start on Jan 1 + 7k of a year."""
    lo, hi = day(first), day(last)
    out = []
    for year in range(date_of(lo).year, date_of(hi).year + 1):
        if unit == "year":
            spans = [(f"{year}-01-01", f"{year}-12-31")]
        elif unit == "month":
            spans = []
            for m in range(1, 13):
                end = datetime.date(year + (m == 12), m % 12 + 1, 1) - datetime.timedelta(days=1)
                spans.append((f"{year}-{m:02d}-01", end.isoformat()))
        elif unit == "week":
            jan1 = day(f"{year}-01-01")
            spans = [(date_of(jan1 + 7 * k).isoformat(), date_of(jan1 + 7 * k + 6).isoformat()) for k in range(52)]
        else:
            raise ValueError(f"unknown window unit {unit!r}")
        out += [(day(a), day(b)) for a, b in spans if day(a) >= lo and day(b) <= hi]
    return out
