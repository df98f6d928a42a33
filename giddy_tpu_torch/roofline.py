"""Speed-of-light accounting of a decode on the card (counterpart of
giddy_tpu/roofline.py :1-130).

The least a decode can move is its compressed streams read once and its
decoded column written once, whatever implements it; the floor time is
those bytes over the card's memory rate (:func:`chip_bw`).
:func:`traffic_audit` is the single-pass evidence: the decoder that
``api.decode`` dispatches, run once more on streams already on the card,
must allocate nothing beside its output (``temp_bytes == 0``).

The reference's ``ops_budget``/``ops_audit`` (a census of Mosaic programs
against a TPU's issue slots) have no counterpart here (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

from .format import EncodedColumn

# Device memory rates (bytes/s) from NVIDIA's H100 data sheet, keyed by
# torch.cuda.get_device_name(): the SXM part (80 GB HBM3), the PCIe part
# (80 GB HBM2e) and the NVL part (94 GB HBM3).
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def chip_bw(device_name: str | None = None) -> float:
    """The memory rate of ``device_name`` (by default the current card's);
    a card not in :data:`HBM_BW` raises ``ValueError``."""
    if device_name is None:
        device_name = torch.cuda.get_device_name()
    try:
        return HBM_BW[device_name]
    except KeyError:
        raise ValueError(f"no memory rate known for {device_name!r} (known: {sorted(HBM_BW)})") from None


@dataclasses.dataclass
class Roofline:
    decoded_bytes: int
    compressed_bytes: int
    hbm_bw: float

    @property
    def bytes_touched(self) -> int:
        return self.decoded_bytes + self.compressed_bytes

    @property
    def floor_time_s(self) -> float:
        return self.bytes_touched / self.hbm_bw

    @property
    def sol_decode_gbps(self) -> float:
        """Decoded GB/s at speed of light."""
        return self.decoded_bytes / 1e9 / self.floor_time_s

    def sol_fraction(self, measured_time_s: float) -> float:
        """The floor time over a measured one."""
        return self.floor_time_s / max(measured_time_s, 1e-12)


def column_roofline(col: EncodedColumn, device_name: str | None = None) -> Roofline:
    return Roofline(
        decoded_bytes=col.nbytes_decoded,
        compressed_bytes=col.nbytes_compressed,
        hbm_bw=chip_bw(device_name),
    )


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def traffic_audit(col: EncodedColumn, device: torch.device | str = "cuda") -> dict:
    """Bytes the decoder of ``col`` touches on ``device``, the reference's
    keys and definitions: ``args_bytes`` of its uploaded streams,
    ``out_bytes`` of its (padded, storage-width) output, ``temp_bytes``
    that it allocates beside them, ``traffic = args + out + 2*temp`` (a
    temporary is written once and read once), ``ratio = traffic / (args +
    out)`` and ``sol_ratio = traffic / (compressed + out)``, which also
    charges the host prep's inflation of the streams. A ratio r caps the
    decode at 1/r of speed of light.

    On the card the streams are uploaded and the decoder run once before
    the measured run (the first launch loads the kernel library), and
    ``temp_bytes`` is the allocator's peak during that run less what is
    still allocated after it: the allocation before the call and the
    output's block (which the caching allocator may hand out up to 1 MB
    larger than the output; a decoder that returns its input, raw, holds
    none). On the CPU (``interpreted``: the plain versions run) torch keeps
    no allocator statistics: ``temp_bytes`` and the ratios are None and the
    byte accounting alone is reported."""
    from . import api

    device = api._decode_device(device)
    fn = api.get_decoder(col, api.narrow_store_dtype(col))
    streams = api.device_streams(col, device)
    args = sum(_nbytes(t) for t in streams.values())
    temp = None
    if device.type == "cuda":
        fn(streams)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn(streams)
        torch.cuda.synchronize(device)
        temp = torch.cuda.max_memory_allocated(device) - torch.cuda.memory_allocated(device)
    else:
        out = fn(streams)
    out_bytes = _nbytes(out)
    traffic = None if temp is None else args + out_bytes + 2 * temp
    return {
        "scheme": col.scheme,
        "n": col.n,
        "args_bytes": args,
        "out_bytes": out_bytes,
        "temp_bytes": temp,
        "traffic_bytes": traffic,
        "ideal_bytes": args + out_bytes,
        "ratio": None if traffic is None else traffic / max(args + out_bytes, 1),
        "sol_ratio": None if traffic is None else traffic / max(col.nbytes_compressed + out_bytes, 1),
        "compressed_bytes": col.nbytes_compressed,
        "decoded_bytes": col.nbytes_decoded,
        "interpreted": device.type != "cuda",
    }
