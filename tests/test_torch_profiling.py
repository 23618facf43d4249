"""The port's span recorder (``wsinsight_tpu_torch/utils/profiling.py``) on
the CPU: spans off record nothing and read no clock; spans on carry their
parent, thread, wall and thread CPU time on the clock of torch.profiler's
events; the bounded buffer drops its oldest spans and counts them;
``hot_stage_report`` sums the buffer by name; ``maybe_trace`` writes the
stage's spans into its Chrome trace."""

import collections
import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from wsinsight_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture
def recorder(monkeypatch):
    """Spans on, into an empty buffer of their own."""
    monkeypatch.setattr(profiling, "_PROF_ENABLED", True)
    monkeypatch.setattr(profiling, "_BUF", collections.deque(maxlen=profiling._CAPACITY))
    for name in ("_recorded", "_dropped", "_report_mark"):
        monkeypatch.setattr(profiling, name, 0)
    return profiling


class _Clock:
    """A stand-in for the ``time`` module whose clocks step 1 ms per read."""

    def __init__(self):
        self.now = 0

    def time_ns(self):
        self.now += 1_000_000
        return self.now

    thread_time_ns = time_ns


def _boom():
    raise AssertionError("a disabled span read a clock")


def test_spans_off_record_nothing_and_read_no_clock(monkeypatch):
    monkeypatch.setattr(profiling, "_PROF_ENABLED", False)
    monkeypatch.setattr(profiling, "_BUF", collections.deque(maxlen=8))
    with monkeypatch.context() as m:
        m.setattr(time, "time_ns", _boom)
        m.setattr(time, "thread_time_ns", _boom)
        with profiling.hot_stage("off", n=3, device=torch.device("cpu")) as span:
            span.n = 4
            assert span is profiling._OFF and span.id is None
            with profiling.hot_stage("off.inner", parent=span.id):
                pass
    assert profiling.spans() == [] and profiling.hot_stage_report() == {}
    # the control: the same span, on, reads the clocks
    monkeypatch.setattr(profiling, "_PROF_ENABLED", True)
    with monkeypatch.context() as m:
        m.setattr(time, "thread_time_ns", _boom)
        with pytest.raises(AssertionError, match="read a clock"):
            with profiling.hot_stage("on"):
                pass


def test_nested_spans_carry_parents_threads_and_cpu(recorder):
    def work(seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            pass

    with recorder.hot_stage("outer", n=7) as outer:
        work(0.002)
        with recorder.hot_stage("inner"):
            time.sleep(0.002)
        with recorder.hot_stage("inner"):
            work(0.001)
    done = threading.Event()

    def child():
        with recorder.hot_stage("other.thread", parent=outer.id):
            with recorder.hot_stage("other.inner"):
                work(0.001)
        done.set()

    threading.Thread(target=child).start()
    assert done.wait(10)
    by_name = collections.defaultdict(list)
    for s in recorder.spans():
        by_name[s.name].append(s)
    (o,), inners = by_name["outer"], by_name["inner"]
    (t,), (ti,) = by_name["other.thread"], by_name["other.inner"]
    main = threading.get_native_id()
    assert o.parent is None and o.n == 7 and o.thread == main
    assert [s.parent for s in inners] == [o.id, o.id] and {s.thread for s in inners} == {main}
    assert t.parent == o.id and ti.parent == t.id and t.thread == ti.thread != main
    for s in (o, *inners, t, ti):
        assert s.start_ns <= s.end_ns and 0 <= s.cpu_ns <= s.end_ns - s.start_ns
        assert s.device_ms is None
    for s in inners:
        assert o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns
    # the sleeping span spent its wall time off the CPU, the spinning one on it
    assert inners[0].cpu_ns < 0.5 * (inners[0].end_ns - inners[0].start_ns)
    assert inners[1].cpu_ns > 0


def test_explicit_parent_across_threads(recorder):
    """A job handed to another thread carries its span's id; the worker's
    span names it as parent, and the worker's own nesting continues below."""
    import queue

    jobs: queue.Queue = queue.Queue()

    def worker():
        while (job := jobs.get()) is not None:
            with recorder.hot_stage("job.run", n=job[0], parent=job[1]):
                with recorder.hot_stage("job.step"):
                    pass

    t = threading.Thread(target=worker)
    t.start()
    ids = []
    for i in range(3):
        with recorder.hot_stage("job.enqueue", n=i) as span:
            pass
        ids.append(span.id)
        jobs.put((i, span.id))
    jobs.put(None)
    t.join(10)
    assert not t.is_alive()
    got = recorder.spans()
    runs = {s.n: s for s in got if s.name == "job.run"}
    steps = {s.parent for s in got if s.name == "job.step"}
    assert [runs[i].parent for i in range(3)] == ids
    assert steps == {runs[i].id for i in range(3)}


def test_hot_stage_report_sums_and_reset_keeps_spans(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "time", _Clock())
    for _ in range(2):
        with recorder.hot_stage("a"):  # a span reads two clocks in and two out:
            with recorder.hot_stage("b"):  # 3 ms of wall, 7 ms around another span
                pass
    with recorder.hot_stage("c"):
        pass
    report = recorder.hot_stage_report(reset=False)
    assert report == pytest.approx({"a": 0.014, "b": 0.006, "c": 0.003})
    assert list(recorder.hot_stage_report()) == ["a", "b", "c"]  # longest first
    assert recorder.hot_stage_report() == {}
    assert [s.name for s in recorder.spans()] == ["b", "a", "b", "a", "c"]
    with recorder.hot_stage("b"):
        pass
    assert recorder.hot_stage_report() == pytest.approx({"b": 0.003})
    assert len(recorder.spans()) == 6


def test_buffer_bound_drops_oldest_and_counts(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "_BUF", collections.deque(maxlen=3))
    for i in range(5):
        with recorder.hot_stage(f"s{i}"):
            pass
    assert [s.name for s in recorder.spans()] == ["s2", "s3", "s4"]
    assert recorder.dropped() == 2
    assert set(recorder.hot_stage_report()) == {"s2", "s3", "s4"}


def test_spans_share_the_profilers_clock(recorder):
    """A torch.profiler record_function event inside a span starts and ends
    within the span's time_ns bounds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.hot_stage("span") as span:
            time.sleep(0.003)
            with record_function("inside"):
                torch.ones(16) + 1
            time.sleep(0.003)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    assert span.start_ns <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= span.end_ns


def test_maybe_trace_writes_spans_into_its_trace(recorder, monkeypatch, tmp_path):
    from torch.profiler import record_function

    monkeypatch.setenv("WSINSIGHT_PROFILE", str(tmp_path))
    with recorder.hot_stage("before.stage"):
        pass
    with profiling.maybe_trace("stage_s"):
        with recorder.hot_stage("s.work", n=5) as span:
            time.sleep(0.002)
            with record_function("s.inside"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.002)
    (path,) = (tmp_path / "stage_s").glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    mine = [e for e in events if e.get("cat") == "wsinsight_span"]
    assert [e["name"] for e in mine] == ["s.work"]  # only the stage's spans
    (ev,) = mine
    assert ev["ph"] == "X" and ev["tid"] == threading.get_native_id()
    assert ev["args"]["id"] == span.id and ev["args"]["n"] == 5
    assert ev["ts"] == pytest.approx((span.start_ns - trace["baseTimeNanoseconds"]) / 1e3)
    (rf,) = [e for e in events if e.get("name") == "s.inside"]
    assert ev["ts"] <= rf["ts"] and rf["ts"] + rf["dur"] <= ev["ts"] + ev["dur"]


def test_threads_recording_at_once_lose_no_span(recorder):
    """More threads than cores record nested spans with the interpreter
    switching threads every microsecond: every span is kept once, with a
    unique id and its own thread's parent."""
    import os
    import sys

    n_threads, per = (os.cpu_count() or 4) + 4, 200

    def work():
        for i in range(per):
            with recorder.hot_stage("outer", n=i):
                with recorder.hot_stage("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = recorder.spans()
    by_id = {s.id: s for s in got}
    assert len(got) == len(by_id) == 2 * n_threads * per
    inner = [s for s in got if s.name == "inner"]
    assert all(by_id[s.parent].name == "outer" and by_id[s.parent].thread == s.thread
               for s in inner)
    assert recorder.hot_stage_report()["outer"] > 0 and recorder.dropped() == 0
