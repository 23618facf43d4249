"""Tracing and per-stage timing.

The reference ships no profiling (SURVEY.md §5 "Tracing / profiling: none");
the rebuild adds:

* `stage_timer` — wall-clock per pipeline stage, collected into the run
  metadata JSON,
* `maybe_trace` — the stage timer around a stage. The JAX package also
  writes a profiler trace when WSINSIGHT_PROFILE=<dir> is set; the port
  does not yet, and refuses the variable rather than ignore it.
"""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def maybe_trace(stage: str) -> Iterator[None]:
    """Time ``stage``; WSINSIGHT_PROFILE raises until the port's trace exists."""
    if os.getenv("WSINSIGHT_PROFILE"):
        raise NotImplementedError(not_ported("WSINSIGHT_PROFILE (a profiler trace per stage)", 10))
    with stage_timer(stage):
        yield
