"""Cascade decode: the dictionary stage fused into the inner scheme's kernel.

Counterpart of giddy_tpu/kernels/cascade.py:30, which has no kernel of its
own: it hands the dictionary to the inner kernel as a ``_lut_d_pad`` stage
and falls back to an XLA take above ``DICT_PALLAS_MAX`` = 2048 entries (a
TPU cost threshold) or for a ``raw`` inner. Here every inner kernel of
``INNER_SCHEMES`` takes the table itself (``gt::Lut`` in csrc/lmp.cuh) at
every d >= 1: K1 (nbit, dzbf), K2 (for), K3 (delta), K5 and K6 (rle, rpe
in tile or scatter form), K7 (delta2). A ``raw`` inner is LMP(32) word for
word (FORMAT.md §0.1 with B = 32), so cascade over raw is K4 with 32-bit
codes. ``LAUNCHES`` counts the fused launches on a CUDA device.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn
from ..ref.cascade import codes_column
from ..util import GROUP, LANES, num_groups

LAUNCHES = 0


def prep(col: EncodedColumn) -> dict:
    """Host prep (giddy_tpu/kernels/cascade.py:62-66): the dictionary plus
    the inner scheme's prepped streams under ``c_``."""
    inner = codes_column(col)
    p = registry.get(inner.scheme).prep_streams
    c_streams = p(inner) if p is not None else inner.streams
    return {"values": col.streams["values"], **{f"c_{k}": v for k, v in c_streams.items()}}


def kernel_call(col: EncodedColumn, streams: dict, out_store: torch.dtype) -> tuple[str, tuple]:
    """(kernel name, wrapper arguments) of the inner kernel that decodes
    ``col`` (d >= 1) from its prepped streams, the dictionary last, as the
    wrapper's ``lut`` (K4's ``values`` for a raw inner)."""
    from . import kernel_call as inner_call  # the package's dispatch, which imports this module

    inner = codes_column(col, streams={k[2:]: v for k, v in streams.items() if k.startswith("c_")})
    values = streams["values"]
    if inner.scheme == "raw":
        data = inner.streams["data"]
        return "dict_decode", (data.view(-1, 32 * LANES), values, 32, out_store)
    name, args = inner_call(inner, inner.streams, out_store)
    return name, (*args, values)


def cascade_lut(name: str, args: tuple) -> torch.Tensor:
    """Launch kernel ``name`` with its table (``args`` as :func:`kernel_call`
    gives them); counts one fused launch on a CUDA device."""
    global LAUNCHES
    from . import WRAPPERS

    out = getattr(WRAPPERS[name], name)(*args)
    if out.is_cuda:
        LAUNCHES += 1
    return out



def census(name: str, args: tuple) -> list:
    """The launch of :func:`cascade_lut` on ``args`` (roofline.ops_audit):
    the inner kernel's, with its table."""
    from . import WRAPPERS

    inner, inner_args = args
    return WRAPPERS[inner].census(inner, inner_args)

def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    if col.params["dict_size"] == 0:
        # empty column, no dictionary: the padded codes are all zero, as
        # the reference returns them (cascade.py:50-51), and no kernel runs
        def empty(streams):
            return torch.zeros(num_groups(col.n) * GROUP, dtype=out_store, device=streams["values"].device)

        return empty

    return lambda streams: cascade_lut(*kernel_call(col, streams, out_store)).reshape(-1)


registry.register_device("cascade", build, prep, narrow_store=True)
