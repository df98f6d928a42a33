"""giddy_tpu_torch.roofline on the CPU against giddy_tpu.roofline: the
roofline's byte counts, the traffic audit's byte accounting (its streams
against the reference's ``api.device_streams``, computed in a fresh
process, and its storage-width outputs) and the table of memory rates.
The audit's temporary bytes need the card's allocator: on the CPU they are
None, and tests/test_torch_cuda.py holds them on the card."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
from giddy_tpu import roofline as gt_roofline
import giddy_tpu_torch as gtt
from giddy_tpu_torch import roofline
from giddy_tpu_torch.datagen import CORE_SCHEMES, gen_column
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import FreshProcess, rng_of

N = 8 * GROUP  # the reference's audit size (tests/test_roofline.py)
H100_SXM = "NVIDIA H100 80GB HBM3"


def _column(scheme: str):
    v = gen_column(scheme, N, rng_of(f"roofline/{scheme}"))
    return v, gtt.encode(v, scheme, name=f"audit_{scheme}")


def reference_args_bytes(values: np.ndarray, scheme: str) -> int:
    """The byte total of giddy_tpu.api.device_streams of the reference's
    column (run in a fresh process: it places arrays with JAX)."""
    from giddy_tpu import api

    streams = api.device_streams(gt.encode(values, scheme, name=f"audit_{scheme}"))
    return sum(int(np.asarray(s).nbytes) for s in streams.values())


@pytest.fixture(scope="module")
def reference():
    process = FreshProcess()
    yield process
    process.close()


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_column_roofline_matches_reference(scheme):
    v, col = _column(scheme)
    want = gt_roofline.column_roofline(gt.encode(v, scheme, name=f"audit_{scheme}"), "v5e")
    got = roofline.column_roofline(col, H100_SXM)
    assert (got.decoded_bytes, got.compressed_bytes, got.bytes_touched) == (
        want.decoded_bytes, want.compressed_bytes, want.bytes_touched)
    assert got.hbm_bw == 3.35e12 and got.floor_time_s == got.bytes_touched / 3.35e12
    assert got.sol_decode_gbps == pytest.approx(got.decoded_bytes / 1e9 / got.floor_time_s)
    assert got.sol_fraction(2 * got.floor_time_s) == pytest.approx(0.5)


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_audit_streams_match_reference(reference, scheme):
    v, col = _column(scheme)
    a = roofline.traffic_audit(col, "cpu")
    assert a["args_bytes"] == reference(reference_args_bytes, v, scheme)
    assert a["out_bytes"] == N * 4 and a["ideal_bytes"] == a["args_bytes"] + a["out_bytes"]
    assert a["interpreted"] is True and a["temp_bytes"] is None
    assert a["traffic_bytes"] is a["ratio"] is a["sol_ratio"] is None
    assert (a["scheme"], a["n"], a["compressed_bytes"], a["decoded_bytes"]) == (
        scheme, N, col.nbytes_compressed, col.nbytes_decoded)


NARROW = [
    ("nbit", "uint8"), ("for", "uint16"), ("delta", "int16"), ("dict", "int8"), ("rle", "int16"),
    ("dzbv", "uint16"), ("bitmap", "uint8"), ("patched", "int16"), ("cascade", "int16"), ("raw", "int8"),
]


@pytest.mark.parametrize("n", [GROUP + 5, 40 * GROUP + 13])
@pytest.mark.parametrize("scheme,dtype", NARROW)
def test_audit_out_bytes_at_storage_width(scheme, dtype, n):
    """The decoder's output is the column's storage width a value (raw
    keeps its int32 payload, as the reference's raw does), over whole
    groups, at one group and at many."""
    rng = rng_of(f"roofline/narrow/{scheme}/{dtype}/{n}")
    v = (np.repeat(rng.integers(0, 4, n // 8 + 1), 8)[:n] * 7).astype(dtype)  # bitmap: d = 4
    col = gtt.encode(v, scheme)
    a = roofline.traffic_audit(col, "cpu")
    width = 4 if scheme == "raw" else np.dtype(dtype).itemsize
    assert a["out_bytes"] == -(-n // GROUP) * GROUP * width


def test_chip_bw_table():
    assert roofline.chip_bw(H100_SXM) == 3.35e12
    assert roofline.chip_bw("NVIDIA H100 PCIe") == 2.0e12
    assert roofline.chip_bw("NVIDIA H100 NVL") == 3.9e12
    for name in ("TPU v5 lite", "v5e", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no memory rate known"):
            roofline.chip_bw(name)
    _, col = _column("nbit")
    with pytest.raises(ValueError, match="TPU v5p"):
        roofline.column_roofline(col, "TPU v5p")


def test_audit_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py audits there")
    _, col = _column("nbit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.traffic_audit(col)
