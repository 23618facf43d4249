"""The readers of the program's spans (``program_spans.py`` and the metrics
that use it) on synthetic spans: each number from hand-made spans inside
the window, spans outside it left out, and nothing read (None, not an
error) where the program recorded none, dropped some, or has no recorder."""

from __future__ import annotations

import types

import pytest

from conftest import ROOT

from portbench.common import Spans, load_module, reader_path

W0 = 1_000_000_000_000  # the window's first span starts here (ns)
MS = 1_000_000


def _span(name, start_ms, end_ms, cpu_ms=0.0, n=0, device_ms=None, id=0, parent=None):
    return types.SimpleNamespace(name=name, start_ns=W0 + int(start_ms * MS),
                                 end_ns=W0 + int(end_ms * MS), cpu_ns=int(cpu_ms * MS), n=n,
                                 device_ms=device_ms, id=id, parent=parent, thread=1)


SPANS = [
    _span("engine.step", -50, -40, device_ms=99.0),  # the warm-up: before the window
    _span("stream.batch", 0, 100, cpu_ms=60),
    _span("stream.batch", 100, 200, cpu_ms=20),
    _span("engine.step", 1, 90, device_ms=110.0),
    _span("engine.step", 101, 190, device_ms=130.0),
    _span("engine.step", 2001, 2002, device_ms=500.0),  # after the window
    _span("flush.enqueue", 50, 52, id=10),
    _span("flush.enqueue", 150, 151, id=11),
    _span("flush.band", 55, 300, cpu_ms=1500, n=40, id=20, parent=10),
    _span("flush.band", 161, 400, cpu_ms=500, n=2, id=21, parent=11),
    _span("flush.band", 170, 180, cpu_ms=5, id=22, parent=3),  # its enqueue is outside
    _span("decode.shard", 10, 20, n=1),
    _span("decode.shard", 20, 40, n=2),
    _span("engine.put", 0, 6),
    _span("engine.put", 100, 105),
    _span("put.pin", 0, 5),
    _span("put.pin", 100, 104),
    _span("put.copy", 5, 6),
    _span("classify.preprocess", 1, 2, device_ms=0.2),
    _span("classify.preprocess", 101, 102, device_ms=0.3),
]

WANT = {
    "dispatch_offcpu_pct.slide": 100.0 * (200 - 80) / 200,
    "step_device_ms.slide": 120.0,
    "step_device_ms.step": 120.0,
    "flush_cpu_s.slide": 2.005 / 2,
    "flush_queue_wait_ms.slide": (3 + 10) / 2,
    "decode_patches_per_s.slide": 3 / 0.030,
    "put_pin_ms.step": 4.5,
    "preprocess_device_ms.step": 0.25,
}


@pytest.fixture
def recorded(monkeypatch):
    """The program's recorder holding SPANS, nothing dropped."""
    from wsinsight_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    return profiling


def _run():
    spans = Spans()
    spans.ns.append(("plan", W0, W0 + 80 * MS))
    spans.ns.append(("finalize", W0 + 500 * MS, W0 + 600 * MS))
    return {"spans": spans, "window_s": 2.0, "slides": [{}, {}]}


def _read(name, run):
    return load_module(reader_path(name), "m_" + name.replace(".", "_")).read(run, None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_windows_spans(recorded, name):
    assert _read(name, _run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_where_spans_dropped_or_absent(recorded, monkeypatch, name):
    monkeypatch.setattr(recorded, "dropped", lambda: 1)
    assert _read(name, _run()) is None
    monkeypatch.setattr(recorded, "dropped", lambda: 0)
    monkeypatch.setattr(recorded, "spans", lambda: [])
    assert _read(name, _run()) is None
    # an older program, without the recorder
    monkeypatch.delattr(recorded, "spans")
    monkeypatch.delattr(recorded, "dropped")
    assert _read(name, _run()) is None


def test_every_program_span_metric_is_in_the_benchmark():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        assert by_name[name]["source"] in ("program_span", "program_counter")
        assert reader_path(name).is_file()
