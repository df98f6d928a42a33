"""Tables drawn on the device from the seed, by a configuration's column
definitions.

A configuration lists its columns in order; each names a generator, a
module ``datagen/<generator>.py`` with ``generate(table, args)`` that
returns the column as an int32 tensor of the table's rows. A generator may
read columns listed before it (``table.columns``) and per-order values
(``table.per_order``). Every draw comes from one ``torch.Generator`` seeded
with the run's seed, in the configuration's order, so one seed gives the
same table on the same device. After the last generator the table is
clustered (stably sorted) by ``cluster_by`` when the configuration asks,
date columns take their stored encoding, and only the resident columns
(those with a ``scheme``) are kept.
"""

from __future__ import annotations

import importlib
import re

import torch

from .. import dates

_NAME = re.compile(r"[A-Za-z0-9_]+")


def generator(name: str):
    """The generator module of ``name`` (a file of this package)."""
    if not _NAME.fullmatch(name) or name.startswith("_"):
        raise ValueError(f"bad generator name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def torch_seed(seed: int) -> int:
    """The run's seed as torch.Generator.manual_seed takes it (any whole
    number, wrapped to 64 bits)."""
    return int(seed) % 2**64


class Table:
    """The rows being drawn: ``n`` rows on ``device``, the columns drawn so
    far, and the orders they belong to (drawn at first use)."""

    def __init__(self, n: int, device, gen: torch.Generator, orders: dict | None):
        self.n = n
        self.device = torch.device(device)
        self.gen = gen
        self.columns: dict[str, torch.Tensor] = {}
        self._orders_spec = orders
        self._lines = None

    def randint(self, low: int, high: int, size: int) -> torch.Tensor:
        """``size`` int32 draws, uniform over [low, high] inclusive."""
        return torch.randint(low, high + 1, (size,), generator=self.gen, device=self.device, dtype=torch.int32)

    def lines_per_order(self) -> torch.Tensor:
        """Lines of each order in row order (int64), the last order cut so
        that they add up to exactly ``n`` rows: orders of uniform
        ``lines_per_order`` lines, drawn in chunks until they cover n."""
        if self._lines is None:
            if self._orders_spec is None:
                raise ValueError("this configuration defines no orders")
            lo, hi = self._orders_spec["lines_per_order"]
            chunk = int(self.n / ((lo + hi) / 2) * 1.01) + 64
            parts, total = [], 0
            while total < self.n:
                part = self.randint(lo, hi, chunk).long()
                parts.append(part)
                total += int(part.sum())
            lines = torch.cat(parts)
            ends = torch.cumsum(lines, 0)
            k = int(torch.searchsorted(ends, torch.tensor([self.n], device=self.device))[0])
            lines = lines[: k + 1].clone()
            lines[k] -= int(ends[k]) - self.n
            self._lines = lines
        return self._lines

    def per_order(self, values: torch.Tensor) -> torch.Tensor:
        """One value an order, repeated on each of its lines."""
        return torch.repeat_interleave(values, self.lines_per_order(), output_size=self.n)

    def orders(self) -> int:
        return int(self.lines_per_order().shape[0])


def resident(config: dict) -> list[dict]:
    """The column definitions that the program holds (those with a scheme),
    in the configuration's order."""
    return [c for c in config["columns"] if c.get("scheme")]


def build(config: dict, seed: int, device, rows: int | None = None) -> dict[str, torch.Tensor]:
    """The configuration's resident columns, drawn from ``seed`` on
    ``device``: int32 tensors of ``rows`` (by default the configuration's)
    rows each, in the configuration's order."""
    n = int(rows if rows is not None else config["rows"])
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
    table = Table(n, device, gen, config.get("orders"))
    for spec in config["columns"]:
        col = generator(spec["generator"]).generate(table, spec.get("args", {}))
        if col.shape != (n,) or col.dtype != torch.int32:
            raise ValueError(f"generator {spec['generator']!r} gave {tuple(col.shape)} {col.dtype} for {spec['name']!r}")
        table.columns[spec["name"]] = col
    keep = {c["name"]: table.columns[c["name"]] for c in resident(config)}
    del table
    key = config.get("cluster_by")
    if key:
        order = torch.sort(keep[key], stable=True).indices
        keep = {name: col[order] for name, col in keep.items()}
        del order
    for spec in resident(config):
        if spec.get("date"):
            keep[spec["name"]] = dates.encode(keep[spec["name"]], spec["date"])
    return keep
