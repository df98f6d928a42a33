"""The frozen byte counts against bytes counted by hand, and the readers
of the trace on a made-up trace."""

import numpy as np
import pytest

from benchmark import metrics, tracing, yardstick
from benchmark.runners import Window
from giddy_tpu_torch import api

N = 3 * 32768 + 1234  # four groups
NG = 4


@pytest.mark.parametrize("scheme,values,hand", [
    # nbit at 4 bits: 1024 words a group a bit
    ("nbit", np.arange(N, dtype=np.int32) % 11, NG * 4 * 1024 * 4),
    # for at 12 bits: the packed words and one reference a frame (frame = group)
    ("for", 8036 + np.arange(N, dtype=np.int32) % 2500, NG * 12 * 1024 * 4 + NG * 4),
    # rle with one run a group: run values and ends, 8 a group (r_pad), and a count a group
    ("rle", np.repeat(np.arange(4, dtype=np.int32), 32768)[:N], 2 * NG * 8 * 4 + NG * 4),
])
def test_least_bytes_by_hand(scheme, values, hand):
    col = api.encode(values, scheme)
    stream_bytes = sum(s.nbytes for s in col.streams.values())
    assert stream_bytes == hand
    assert yardstick.least_bytes("lmp_unpack_kernel", stream_bytes, N, 4) == hand + 4 * N
    assert yardstick.least_bytes("filter_fold_kernel", stream_bytes, N, 4) == hand + NG * 1024 * 4
    assert yardstick.least_bytes("some_new_kernel", stream_bytes, N, 4) is None


def test_port_kernel_names():
    assert yardstick.port_kernel("void gt::for_unpack_kernel<unsigned int, (gt::LutMode)0>(unsigned int const*)") == "for_unpack_kernel"
    assert yardstick.port_kernel("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<int>>") is None


def made_up_trace():
    """1 ms of window: a K16 of column a (0.1 ms), a torch op (0.2 ms), a
    K1 decode of column b (0.3 ms), idle between."""
    ms = 1_000_000
    ops = [
        tracing.DeviceOp("void gt::filter_fold_kernel<(gt::Kind)1, (gt::Op)2>(...)", 0, ms // 10, "filter:a"),
        tracing.DeviceOp("void at::native::reduce_kernel<512>(...)", 2 * ms // 10, 4 * ms // 10, "count"),
        tracing.DeviceOp("void gt::lmp_unpack_kernel<unsigned int>(...)", 5 * ms // 10, 8 * ms // 10, "decode:b"),
    ]
    spans = [(0, 10, "filter:a"), (20, 30, "count"), (40, 50, "decode:b")]
    return tracing.Trace(0, ms, ops, spans, [s for s, _, _ in spans])


def test_readers_on_a_made_up_trace():
    w = Window(answers=[1, 2])
    cols = {"a": (1_000_000, 32768, 4), "b": (2_000_000, 32768, 4)}
    ctx = metrics.Context(1.0, w, cols, made_up_trace())
    roofline, other_ms, idle = (metrics.reader(m) for m in ("kernel_roofline_pct.query", "torch_ops_ms.query",
                                                             "device_idle_pct.decode"))
    least = (1_000_000 + 4096) / 3.35e12 + (2_000_000 + 4 * 32768) / 3.35e12
    assert roofline(ctx) == pytest.approx(100 * least / 0.4e-3)
    assert other_ms(ctx) == pytest.approx(0.2 / 2)
    assert idle(ctx) == pytest.approx(40.0)
    b = tracing.breakdown(ctx.trace)
    assert b["device_ops"][0][1] == pytest.approx(0.3e-3) and len(b["idle_gaps"]) >= 1
    # a port kernel tied to no program call, or to a column the run does not hold: nothing to read
    ctx.columns = {"a": cols["a"]}
    assert roofline(ctx) is None
    ctx.trace = None
    assert roofline(ctx) is None and idle(ctx) is None


def test_issue_is_read_from_the_untraced_window():
    traced, untraced = Window(issue_s=[200e-6, 180e-6]), Window(issue_s=[40e-6, 50e-6])
    issue = metrics.reader("issue_us.decode")
    assert issue(metrics.Context(1.0, traced, {}, None, untraced)) == pytest.approx(45.0)
    assert issue(metrics.Context(1.0, traced, {}, None, None)) is None


def test_a_kernel_byte_count_is_a_file_of_its_own():
    """Every port kernel named in a file has a known output, and a kernel
    without a file has no byte count."""
    files = sorted((yardstick._DIR).glob("*.json"))
    assert {f.stem for f in files} >= {"lmp_unpack_kernel", "for_unpack_kernel", "run_strip_kernel", "filter_fold_kernel"}
    assert all(yardstick.output(f.stem) in ("column", "bitmap") for f in files)
    assert yardstick.output("no_such_kernel") is None
