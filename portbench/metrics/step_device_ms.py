"""Whole step (``engine/runner.Replicated.dispatch``): the mean device
milliseconds of each replica's ``engine.step`` span, between CUDA events
recorded on its stream at the step's start and end (the gaps between its
kernels included). Reads ``step_device_ms.slide`` and
``step_device_ms.step``."""

import statistics

from portbench.program_spans import named


def read(run, ctx):
    steps = [s.device_ms for s in named(run, "engine.step") if s.device_ms is not None]
    return statistics.fmean(steps) if steps else None
