"""Tracing and per-stage timing.

The reference ships no profiling (SURVEY.md §5 "Tracing / profiling: none");
the rebuild adds:

* `stage_timer` — wall-clock per pipeline stage, collected into the run
  metadata JSON,
* `maybe_trace` — the stage timer around a stage. The JAX package also
  writes a profiler trace when WSINSIGHT_PROFILE=<dir> is set; the port
  does not yet, and refuses the variable rather than ignore it,
* `hot_stage` / `hot_stage_report` — wall seconds per hot-loop stage (the
  HV post-processing tail), accumulated when WSINSIGHT_STREAM_PROFILE=1.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator

from ..errors import not_ported

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
# Used by the HV post-processing tail: one perf_counter pair per stage call
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
    """Time ``stage``; WSINSIGHT_PROFILE raises until the port's trace exists."""
    if os.getenv("WSINSIGHT_PROFILE"):
        raise NotImplementedError(not_ported("WSINSIGHT_PROFILE (a profiler trace per stage)", 10))
    with stage_timer(stage):
        yield
