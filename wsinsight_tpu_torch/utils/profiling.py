"""Tracing and per-stage timing.

The reference ships no profiling (SURVEY.md §5 "Tracing / profiling: none");
the rebuild adds:

* `stage_timer` — wall-clock per pipeline stage, collected into the run
  metadata JSON,
* `hot_stage` — the port's one span recorder, on when
  WSINSIGHT_STREAM_PROFILE=1 or WSINSIGHT_PROFILE=<dir> is set at import.
  A span records its name, its id and its parent's (the innermost open span
  of its thread, or a parent given from another thread), the thread's
  native id, its start and end on ``time.time_ns()`` (the clock of
  torch.profiler's events), the thread's CPU time over it
  (``time.thread_time_ns()``), an optional count ``n`` and, given a CUDA
  ``device``, its device time: CUDA events recorded on the current stream
  at its start and end, resolved to milliseconds only when the spans are
  read. Spans are kept in a bounded buffer (the oldest dropped, and
  counted, when it is full) and read by `spans()`; off, a span is one flag
  check and reads no clock,
* `hot_stage_report` — wall seconds per span name, summed over threads,
  since the last reset, computed from the buffer,
* `maybe_trace` — the stage timer around a stage and, when
  WSINSIGHT_PROFILE=<dir> is set, a torch.profiler trace of the stage's
  CPU and CUDA activity written under <dir>/<stage>/ (the JAX package
  writes a jax.profiler trace there), with the stage's spans in it: one
  ``"ph": "X"`` event per span on its thread, on the trace's own time base.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Iterator

_STAGE_TIMINGS: dict[str, float] = {}


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STAGE_TIMINGS[name] = _STAGE_TIMINGS.get(name, 0.0) + (time.perf_counter() - t0)


def stage_timings() -> dict[str, float]:
    return {k: round(v, 3) for k, v in _STAGE_TIMINGS.items()}


# -- spans (WSINSIGHT_STREAM_PROFILE=1 or WSINSIGHT_PROFILE=<dir>) -----------
# Used by the hot loops' layers: the plan, the decode pool, the engines' put,
# dispatch and step, the classifier's preprocess and fetch, the streaming
# engine's batches, flushers and finalize, the HV post-processing tail,
# StarDist's plan and CME's phases (each returns host arrays, so its time
# includes the card's work). The flag is read once at import. Thread-safe:
# the flushers and the decode pool record concurrently.

_PROF_ENABLED = (os.getenv("WSINSIGHT_STREAM_PROFILE", "0") not in ("0", "")
                 or bool(os.getenv("WSINSIGHT_PROFILE")))
# A 30 s window of a benchmark cell records 3,000-8,000 spans (a SAM-H slide
# about 1,850, most of them the per-patch decode), its warm-up a few hundred.
_CAPACITY = 1 << 16
_BUF: collections.deque = collections.deque(maxlen=_CAPACITY)
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_LOCAL = threading.local()
_recorded = 0  # spans ever put in the buffer
_dropped = 0  # of those, pushed out by the bound
_report_mark = 0  # _recorded at hot_stage_report's last reset


class Span:
    """One timed stretch of one thread; a context manager that records
    itself into the buffer when it ends. Read its fields from `spans()`:
    ``device_ms`` is None without a CUDA device."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns", "cpu_ns", "n",
                 "device_ms", "_device", "_events")

    def __init__(self, name: str, n: int, parent: int | None, device):
        self.name, self.n, self.parent = name, n, parent
        self._device = device if device is not None and device.type == "cuda" else None
        self._events = None
        self.device_ms = None

    def __enter__(self) -> "Span":
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:  # a thread's first span (its native id is a system call)
            stack = _LOCAL.stack = []
            _LOCAL.thread = threading.get_native_id()
        if self.parent is None and stack:
            self.parent = stack[-1].id
        self.id = next(_IDS)
        self.thread = _LOCAL.thread
        # the thread's CPU clock is read inside the wall clock's reads, and
        # the CUDA events inside both, around the body alone
        self.start_ns = time.time_ns()
        self.cpu_ns = time.thread_time_ns()
        stack.append(self)
        if self._device is not None:
            import torch

            start = torch.cuda.Event(enable_timing=True)
            self._events = (start, torch.cuda.Event(enable_timing=True))
            start.record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc) -> bool:
        global _recorded, _dropped
        if self._events is not None:
            import torch

            self._events[1].record(torch.cuda.current_stream(self._device))
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        self.end_ns = time.time_ns()
        _LOCAL.stack.pop()
        with _LOCK:
            if len(_BUF) == _BUF.maxlen:
                _dropped += 1
            _BUF.append(self)
            _recorded += 1
        return False


class _Off:
    """What `hot_stage` returns while spans are off: enters and exits doing
    nothing; ``n`` may be set and is not read."""

    __slots__ = ("n",)
    id = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def hot_stage(name: str, n: int = 0, parent: int | None = None, device=None):
    """A span named ``name`` when spans are on, else a shared object that
    does nothing. ``n`` is a count (patches, bytes, instances), also
    settable on the span; ``parent`` the id of a span of another thread
    (``span.id``, None while off); ``device`` a ``torch.device`` whose
    current stream times the span on the card where it is CUDA."""
    if not _PROF_ENABLED:
        return _OFF
    return Span(name, n, parent, device)


def spans() -> list[Span]:
    """The buffer's spans in the order they ended, their device time
    resolved (this waits for the card to reach each span's end)."""
    with _LOCK:
        out = list(_BUF)
    for s in out:
        events = s._events
        if events is not None:
            events[1].synchronize()
            s.device_ms = events[0].elapsed_time(events[1])
            s._events = None
    return out


def dropped() -> int:
    """Spans the buffer's bound has dropped since the process started."""
    return _dropped


def hot_stage_report(reset: bool = True) -> dict[str, float]:
    """Wall seconds per span name, summed over threads, of the spans that
    ended since the last reset (empty unless enabled). A reset moves the
    report's start mark; `spans()` keeps every span."""
    global _report_mark
    with _LOCK:
        fresh = min(_recorded - _report_mark, len(_BUF))
        recent = list(itertools.islice(_BUF, len(_BUF) - fresh, None))
        if reset:
            _report_mark = _recorded
    out: dict[str, float] = {}
    for s in recent:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _add_spans(path: str, since_ns: int) -> None:
    """Append the spans that started at or after ``since_ns`` to the Chrome
    trace at ``path``, one complete event each on its thread, timed from the
    trace's ``baseTimeNanoseconds``."""
    with open(path) as fh:
        trace = json.load(fh)
    base, pid = trace.get("baseTimeNanoseconds", 0), os.getpid()
    for s in spans():
        if s.start_ns < since_ns:
            continue
        trace["traceEvents"].append({
            "ph": "X", "cat": "wsinsight_span", "name": s.name, "pid": pid, "tid": s.thread,
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "n": s.n, "cpu_ms": s.cpu_ns / 1e6,
                     "device_ms": s.device_ms}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextlib.contextmanager
def maybe_trace(stage: str) -> Iterator[None]:
    """Time ``stage``; with WSINSIGHT_PROFILE=<dir>, trace it with
    torch.profiler (CPU, and CUDA where a card is present) into
    <dir>/<stage>/ as a Chrome / TensorBoard trace (``*.pt.trace.json``),
    with the spans that started inside the stage."""
    trace_dir = os.getenv("WSINSIGHT_PROFILE")
    if not trace_dir:
        with stage_timer(stage):
            yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(trace_dir, stage)
    os.makedirs(out, exist_ok=True)
    since_ns = time.time_ns()

    def ready(prof) -> None:  # torch.profiler.tensorboard_trace_handler's file name
        path = os.path.join(out, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
                                 ".pt.trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path, since_ns)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=ready):
        with stage_timer(stage):
            yield
