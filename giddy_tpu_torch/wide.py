"""64-bit (wide) columns: the plane-split wrapper (scheme ``wide``).

Counterpart of giddy_tpu/wide.py. A wide column splits into lo/hi 32-bit
planes at encode time, each encoded with any base scheme; per-plane decode
is exact, so ``v = lo | hi << 32`` reconstructs losslessly. Both planes
decode on the card through their own scheme's kernel, and the recombine
runs there too, in int64: the planes travel as int32 payloads, so lo is
zero-extended with ``& 0xFFFFFFFF`` before the OR. uint64 and float64
columns are the same int64 bits under ``Tensor.view``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import registry
from .format import EncodedColumn

# Logical 64-bit dtype -> the torch dtype the recombined int64 bits are viewed as.
TORCH_DTYPES = {"int64": torch.int64, "uint64": torch.uint64, "float64": torch.float64}


def _split(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    u = values.view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def _sub(col: EncodedColumn, plane: str) -> EncodedColumn:
    """The uint32 column of plane ``lo`` or ``hi``, memoized on the parent
    so repeated scans reuse one object (and its cached uploads)."""
    attr = f"_sub_{plane}"
    cached = col.__dict__.get(attr)
    if cached is not None:
        return cached
    sub = EncodedColumn(
        name=f"{col.name}.{plane}",
        scheme=col.params[f"{plane}_scheme"],
        dtype="uint32",
        n=col.n,
        params=col.params[f"{plane}_params"],
        streams={k[len(plane) + 1 :]: v for k, v in col.streams.items() if k.startswith(plane + "_")},
    )
    setattr(col, attr, sub)
    return sub


def encode(
    values: np.ndarray,
    *,
    base_scheme: str = "nbit",
    hi_scheme: str | None = None,
    name: str = "col",
    **base_opts,
) -> EncodedColumn:
    values = np.asarray(values)
    if values.dtype.itemsize != 8:
        raise ValueError(f"wide encode expects a 64-bit column, got {values.dtype}")
    lo, hi = _split(values)
    lo_col = registry.get(base_scheme).encode(lo, name="lo", **base_opts)
    hi_col = registry.get(hi_scheme or base_scheme).encode(hi, name="hi")
    streams = {f"lo_{k}": v for k, v in lo_col.streams.items()}
    streams.update({f"hi_{k}": v for k, v in hi_col.streams.items()})
    return EncodedColumn(
        name=name,
        scheme="wide",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={
            "lo_scheme": lo_col.scheme,
            "lo_params": lo_col.params,
            "hi_scheme": hi_col.scheme,
            "hi_params": hi_col.params,
        },
        streams=streams,
    )


def _combine(lo: np.ndarray, hi: np.ndarray, dtype: str) -> np.ndarray:
    u = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return u.view(np.dtype(dtype))


def combine_device(lo: torch.Tensor, hi: torch.Tensor, dtype: str) -> torch.Tensor:
    """int32-carried planes -> the 64-bit logical tensor: recombined in
    int64 (lo zero-extended), viewed as ``dtype`` at the end."""
    v = hi.to(torch.int64) * 2**32 | (lo.to(torch.int64) & 0xFFFFFFFF)
    return v.view(TORCH_DTYPES[dtype])


def decode_ref(col: EncodedColumn) -> np.ndarray:
    lo_col, hi_col = _sub(col, "lo"), _sub(col, "hi")
    lo = registry.get(lo_col.scheme).decode_ref(lo_col).view(np.uint32)
    hi = registry.get(hi_col.scheme).decode_ref(hi_col).view(np.uint32)
    return _combine(lo, hi, col.dtype)


def plane_payloads(col: EncodedColumn, device: torch.device | str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Both planes decoded on ``device``: two (n_pad,) int32 payload tensors."""
    from .api import device_streams, get_decoder

    lo_col, hi_col = _sub(col, "lo"), _sub(col, "hi")
    return (get_decoder(lo_col)(device_streams(lo_col, device)),
            get_decoder(hi_col)(device_streams(hi_col, device)))


def decode_device(col: EncodedColumn, *, device: torch.device | str = "cuda", pad: bool = False) -> torch.Tensor:
    """Device decode of both planes and the recombine on ``device``: a
    tensor of the logical dtype there, of length n (n_pad with ``pad``)."""
    lo, hi = plane_payloads(col, device)
    if not pad:
        lo, hi = lo[: col.n], hi[: col.n]
    return combine_device(lo, hi, col.dtype)


registry.register("wide", encode, decode_ref)
