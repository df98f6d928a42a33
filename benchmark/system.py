"""The system under test, giddy_tpu_torch, as the benchmark drives it.

This is the only module of the benchmark that imports the program. Set-up
hands each generated column to ``api.encode`` on the host, as a user loads
data, puts its streams on the device once with ``api.device_streams`` and
fetches its cached decoder with ``api.get_decoder``. The measured window
then calls the decoders and the scan layer (``query.filter_bitmap`` /
``between_bitmap`` on those streams, ``bitmap_and``, ``count_bits``), and
reads the port's own launch counters (``kernels/*.LAUNCHES``), so that a
call that answered without launching a kernel shows. Program functions are
looked up on their modules at each call, so a test can put a broken one in
their place. control.py holds the control that stands in for this module.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from giddy_tpu_torch import api, kernels, query


@dataclasses.dataclass
class Resident:
    """One column as the program holds it: the encoded column, its streams
    on the device and its decoder."""

    name: str
    col: object
    streams: dict
    decoder: object

    @property
    def n(self) -> int:
        return self.col.n

    @property
    def itemsize(self) -> int:
        return np.dtype(self.col.dtype).itemsize

    def decoded_bytes(self) -> int:
        """Logical bytes of the decoded column (n values of its dtype)."""
        return self.col.n * self.itemsize

    def stream_bytes(self) -> int:
        """Bytes of the encoded column's streams, as the host encoder made them."""
        return sum(s.nbytes for s in self.col.streams.values())


def _host_copy(values: torch.Tensor, staging: torch.Tensor | None) -> np.ndarray:
    """The column on the host: through a pinned staging buffer from the
    card, or a plain view on the CPU."""
    if values.device.type == "cpu":
        return values.numpy()
    staging[: values.shape[0]].copy_(values)
    return staging[: values.shape[0]].numpy()


def load(columns: dict[str, torch.Tensor], specs: list[dict], device, check_params: bool = True,
         phases: dict | None = None) -> list[Resident]:
    """Encode each generated column on the host with its configured scheme,
    put its streams on ``device`` and fetch its decoder. With
    ``check_params`` the encoder's parameters must equal the configuration's
    (the same work for every seed). ``phases`` collects the seconds of the
    copy to the host, the encode and the upload, by column."""
    phases = {} if phases is None else phases
    device = torch.device(device)
    staging = None
    if device.type == "cuda":
        staging = torch.empty(max(c.shape[0] for c in columns.values()), dtype=torch.int32, pin_memory=True)
    out = []
    for spec in specs:
        t0 = time.perf_counter()
        host = _host_copy(columns[spec["name"]], staging)
        t1 = time.perf_counter()
        col = api.encode(host, spec["scheme"], name=spec["name"])
        t2 = time.perf_counter()
        if any(np.shares_memory(s, host) for s in col.streams.values()):
            col.streams = {k: np.array(s) for k, s in col.streams.items()}
        if check_params and any(col.params.get(k) != v for k, v in spec.get("params", {}).items()):
            raise RuntimeError(f"{spec['name']}: encoded with {col.params}, the configuration states {spec['params']}")
        streams = api.device_streams(col, device)
        out.append(Resident(spec["name"], col, streams, api.get_decoder(col)))
        phases[spec["name"]] = {"to_host": t1 - t0, "encode": t2 - t1, "upload": time.perf_counter() - t2}
    del staging
    return out


def decode(res: Resident) -> torch.Tensor:
    """The decoded column, padded to whole groups (the decoder's output)."""
    return res.decoder(res.streams)


def predicate(res: Resident, op: str, value=None, low=None, high=None) -> torch.Tensor:
    """The bitmap of one predicate on a resident column."""
    if op == "between":
        return query.between_bitmap(res.col, low, high, device=_device(res), streams=res.streams)
    return query.filter_bitmap(res.col, op, value, device=_device(res), streams=res.streams)


def bitmap_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return query.bitmap_and(a, b)


def count(bitmap: torch.Tensor, n: int) -> int:
    """The count of set bits: the answer, on the host."""
    return query.count_bits(bitmap, n)


def launches() -> int:
    """Kernels the port has launched on a CUDA device so far, over every
    wrapper's counter (the CPU's fallbacks count none)."""
    total = 0
    for mod in {id(m): m for m in kernels.WRAPPERS.values()}.values():
        c = mod.LAUNCHES
        total += sum(c.values()) if isinstance(c, dict) else c
    return total


def _device(res: Resident) -> torch.device:
    return next(iter(res.streams.values())).device
