"""Tracing and per-stage timing.

The reference ships no profiling (SURVEY.md §5 "Tracing / profiling: none");
the rebuild adds:

* `stage_timer` — wall-clock per pipeline stage, collected into the run
  metadata JSON,
* `maybe_trace` — the stage timer around a stage and, when
  WSINSIGHT_PROFILE=<dir> is set, a torch.profiler trace of the stage's
  CPU and CUDA activity written under <dir>/<stage>/ (the JAX package
  writes a jax.profiler trace there),
* `hot_stage` / `hot_stage_report` — wall seconds per hot-loop stage (the
  HV post-processing tail, the streaming cell engine's accumulate and
  flush, StarDist's plan, CME's phases), accumulated when
  WSINSIGHT_STREAM_PROFILE=1.
"""

from __future__ import annotations

import contextlib
import os
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


# -- fine-grained hot-loop stage profiling (WSINSIGHT_STREAM_PROFILE=1) ------
# Used by the HV post-processing tail, StarDist's plan (read, normalize,
# copy in, forward, copy out, candidates, NMS) and CME's phases (graph build,
# foundation block, DGI, full-graph embedding, Leiden sweep, Voronoi merge;
# each returns host arrays, so its time includes the card's work):
# one perf_counter pair per stage call
# when enabled, zero work when not (the flag is read once at import).
# Thread-safe: finalize's workers run the tail concurrently.

_PROF_ENABLED = os.getenv("WSINSIGHT_STREAM_PROFILE", "0") not in ("0", "")
_PROF: dict[str, float] = {}
_PROF_LOCK = threading.Lock()


class hot_stage:
    """Context manager accumulating wall seconds under `name` when enabled."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _PROF_ENABLED:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _PROF_ENABLED:
            dt = time.perf_counter() - self.t0
            with _PROF_LOCK:
                _PROF[self.name] = _PROF.get(self.name, 0.0) + dt
        return False


def hot_stage_report(reset: bool = True) -> dict[str, float]:
    """Cumulative stage seconds since the last reset (empty unless enabled)."""
    with _PROF_LOCK:
        out = dict(sorted(_PROF.items(), key=lambda kv: -kv[1]))
        if reset:
            _PROF.clear()
    return out


@contextlib.contextmanager
def maybe_trace(stage: str) -> Iterator[None]:
    """Time ``stage``; with WSINSIGHT_PROFILE=<dir>, trace it with
    torch.profiler (CPU, and CUDA where a card is present) into
    <dir>/<stage>/ as a Chrome / TensorBoard trace (``*.pt.trace.json``)."""
    trace_dir = os.getenv("WSINSIGHT_PROFILE")
    if not trace_dir:
        with stage_timer(stage):
            yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    out = os.path.join(trace_dir, stage)
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(out)):
        with stage_timer(stage):
            yield
