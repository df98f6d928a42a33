"""Scheme registry of the PyTorch port (counterpart of giddy_tpu/registry.py).

Registration is a decorator-free call at import time, as in the reference:
``ref/<scheme>.py`` registers the host codec, ``kernels/<scheme>.py`` the
device decoder. There is no launch plan: every CUDA kernel runs one block
per GROUP, so the grid is the group count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from .format import EncodedColumn

# Schemes the JAX package decodes that the port does not yet, with the
# ROADMAP.md queue-1 item that ports each (none left).
PENDING: dict[str, int] = {}


@dataclasses.dataclass
class Codec:
    scheme: str
    encode: Callable[..., EncodedColumn]
    decode_ref: Callable[[EncodedColumn], np.ndarray]
    # Device decoder builder: build(col, out_store) -> fn(streams) returning
    # the (n_pad,) payload tensor; installed by giddy_tpu_torch.kernels.
    decode_device: Callable[..., Any] | None = None
    # Host-side stream transform run before upload (FOR's per-group refs,
    # rle/rpe's tile or scatter form).
    prep_streams: Callable[[EncodedColumn], dict] | None = None
    # Whether the builder stores int8/int16 columns at storage width.
    narrow_store: bool = False


_REGISTRY: dict[str, Codec] = {}


def register(scheme: str, encode: Callable[..., EncodedColumn], decode_ref: Callable[[EncodedColumn], np.ndarray]) -> Codec:
    codec = Codec(scheme=scheme, encode=encode, decode_ref=decode_ref)
    _REGISTRY[scheme] = codec
    return codec


def register_device(scheme: str, decode_device: Callable[..., Any], prep_streams: Callable[[EncodedColumn], dict] | None = None, narrow_store: bool = False) -> None:
    _REGISTRY[scheme].decode_device = decode_device
    _REGISTRY[scheme].prep_streams = prep_streams
    _REGISTRY[scheme].narrow_store = narrow_store


def get(scheme: str) -> Codec:
    try:
        return _REGISTRY[scheme]
    except KeyError:
        if scheme in PENDING:
            raise NotImplementedError(
                f"scheme {scheme!r} is not ported to giddy_tpu_torch yet "
                f"(ROADMAP.md queue 1, item {PENDING[scheme]})"
            ) from None
        raise KeyError(
            f"scheme {scheme!r} not registered; known: {sorted(_REGISTRY)}"
        ) from None


def schemes() -> list[str]:
    return sorted(_REGISTRY)
