"""The plain reference: the same semantics as the program, worked out
again from the generated columns with plain torch operations.

Decoding is lossless, so the reference decode of a column is the column.
A query's answer is the number of rows that satisfy every predicate. The
control (``dtype=torch.float16``) is this reference computed with each
value, and each constant, held in the 16-bit float type: the step below
exact 32-bit integers, which breaks the configurations' guarantees.
It imports nothing of the program.
"""

from __future__ import annotations

import torch

_CMP = {
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
    "le": torch.le, "gt": torch.gt, "ge": torch.ge,
}


def _as(values: torch.Tensor, dtype) -> torch.Tensor:
    return values if dtype is None else values.to(dtype)


def _const(v: int, like: torch.Tensor):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def predicate_mask(values: torch.Tensor, op: str, value=None, low=None, high=None, dtype=None) -> torch.Tensor:
    """The rows of one column that satisfy one predicate."""
    v = _as(values, dtype)
    if op == "between":
        return (v >= _const(low, v)) & (v <= _const(high, v))
    return _CMP[op](v, _const(value, v))


def mask(columns: dict, where, dtype=None) -> torch.Tensor:
    """The rows that satisfy every predicate of ``where``."""
    out = None
    for p in where:
        m = predicate_mask(columns[p.column], p.op, p.value, p.low, p.high, dtype)
        out = m if out is None else out & m
    return out


def count(columns: dict, where, dtype=None) -> int:
    return int(torch.count_nonzero(mask(columns, where, dtype)))


def counts(columns: dict, queries, dtype=None) -> list[int]:
    """Each query's answer; a predicate set that repeats is worked out once."""
    memo: dict = {}
    out = []
    for q in queries:
        if q.where not in memo:
            memo[q.where] = count(columns, q.where, dtype)
        out.append(memo[q.where])
    return out


def decode(values: torch.Tensor, dtype=None) -> torch.Tensor:
    """The decoded column: the values themselves (the control: through
    ``dtype`` and back)."""
    return values if dtype is None else values.to(dtype).to(values.dtype)
