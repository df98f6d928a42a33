"""The port's own spans (giddy_tpu_torch/trace.py) on the CPU: nothing is
recorded without a profiler, and under one each range has its name and
its place inside its parent, and the CLI's ``decode --trace`` writes them
out. No span is timed here; PERF.md §3 lists the spans and what reads each."""

import contextlib
import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from giddy_tpu_torch import api, cli, datagen, query, registry, trace
from giddy_tpu_torch.kernels import _wrap
from giddy_tpu_torch.util import GROUP

N = 2 * GROUP + 999  # three groups, the last one ragged
DEVICE = torch.device("cpu")


def recorded(fn):
    """The ``giddy.`` ranges ((start, end, name), by start) that ``fn()``
    records under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = prof.profiler.kineto_results.events()
    return sorted(((e.start_ns(), e.end_ns(), e.name()) for e in events if e.name().startswith("giddy.")),
                  key=lambda s: (s[0], -s[1]))


def names(spans):
    return [name for _, _, name in spans]


def one(spans, name):
    found = [s for s in spans if s[2] == name]
    assert len(found) == 1, (name, names(spans))
    return found[0]


def inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1] and child != parent


def column(scheme, n=N, seed=1):
    return api.encode(datagen.gen_column(scheme, n, np.random.default_rng(seed)), scheme)


@pytest.mark.parametrize("what", [None, "nbit", "wait"])
def test_no_profiler_gives_the_shared_no_op(what):
    assert trace.span("decode", what) is trace.OFF
    assert trace.span("launch") is trace.OFF


def test_no_profiler_records_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(trace, "_range", lambda name: opened.append(name))
    monkeypatch.setattr(api, "_DECODER_CACHE", {})
    col = column("for")
    api.decode(col, device=DEVICE)
    api.decode(col, device=DEVICE)
    assert opened == []


DEVICE_SCHEMES = [s for s in registry.schemes() if registry.get(s).decode_device is not None]


@pytest.mark.parametrize("scheme", DEVICE_SCHEMES)
def test_cached_decoder_records_its_decode(scheme, monkeypatch):
    monkeypatch.setattr(api, "_DECODER_CACHE", {})
    col = column(scheme, GROUP + 77)
    first = recorded(lambda: api.get_decoder(col))
    assert names(first) == [f"giddy.build_decoder:{scheme}"]
    decoder = api.get_decoder(col)
    assert recorded(lambda: api.get_decoder(col)) == []
    streams = api.device_streams(col, DEVICE)
    spans = recorded(lambda: decoder(streams))
    assert spans[0][2] == f"giddy.decode:{scheme}" and all(inside(s, spans[0]) for s in spans[1:])


def test_device_streams_records_prep_and_upload():
    # the meta device stands in for the card: its upload is a .to(device)
    col = column("for", GROUP, seed=2)
    spans = recorded(lambda: api.device_streams(col, "meta"))
    outer = one(spans, "giddy.device_streams:for")
    assert inside(one(spans, "giddy.prep:for"), outer)
    uploads = [s for s in spans if s[2] == "giddy.wait:upload"]
    assert len(uploads) == 2 and all(inside(s, outer) for s in uploads)  # packed words, frame refs


@pytest.mark.parametrize("writeable", [True, False])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_upload_waits_only_off_the_cpu(device, writeable):
    streams = {"a": np.arange(GROUP, dtype=np.uint32), "b": np.arange(7, dtype=np.int32)}
    for v in streams.values():
        v.flags.writeable = writeable
    spans = recorded(lambda: api.upload(streams, device))
    assert names(spans) == ([] if device == "cpu" else ["giddy.wait:upload"] * 2)


def test_general_path_filter_carries_its_decode(monkeypatch):
    # an rle column in the scatter form (runs of 2, too dense for run tables): its
    # predicate decodes through the cached decoder, then compares and packs
    monkeypatch.setattr(api, "_DECODER_CACHE", {})
    col = api.encode(np.repeat(np.arange(N // 2 + 1, dtype=np.int32), 2)[:N], "rle")
    streams = api.device_streams(col, DEVICE)
    assert "pos" in streams
    spans = recorded(lambda: query.filter_bitmap(col, "lt", N // 4, device=DEVICE, streams=streams))
    assert names(spans) == ["giddy.build_decoder:rle", "giddy.decode:rle"]


def test_run_table_filter_carries_no_decode(monkeypatch):
    # in the tile form the predicate runs on the run tables (run_filter): no decoder is built or called
    monkeypatch.setattr(api, "_DECODER_CACHE", {})
    col = api.encode(np.repeat(np.arange(N // 100 + 1, dtype=np.int32), 100)[:N], "rle")
    streams = api.device_streams(col, DEVICE)
    assert "vals_w" in streams
    spans = recorded(lambda: query.filter_bitmap(col, "lt", N // 200, device=DEVICE, streams=streams))
    assert names(spans) == []


def test_launch_records_its_entry(monkeypatch):
    called = []
    monkeypatch.setattr(_wrap._build, "lib", lambda: types.SimpleNamespace(gt_probe=lambda *a: called.append(a) or 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=9))
    spans = recorded(lambda: _wrap.launch("gt_probe", DEVICE, 1, 2))
    assert names(spans) == ["giddy.launch:gt_probe"] and called == [(1, 2, 9)]


def test_decode_trace_carries_the_port_spans(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(api, "_DECODER_CACHE", {})
    values = datagen.gen_column("nbit", N, np.random.default_rng(3))
    np.save("v.npy", values)
    cli.main(["encode", "v.npy", "nbit", "--out", "v.gtp", "--device", "cpu"])
    monkeypatch.setattr(api, "_DECODER_CACHE", {})
    cli.main(["decode", "v.gtp", "--trace", "trace", "--device", "cpu", "--out", "d.npy"])
    (path,) = (tmp_path / "trace").glob("*.json")
    found = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    for name in ("build_decoder:nbit", "device_streams:nbit", "prep:nbit", "decode:nbit"):
        assert f"giddy.{name}" in found, name
    np.testing.assert_array_equal(np.load("d.npy"), values)
