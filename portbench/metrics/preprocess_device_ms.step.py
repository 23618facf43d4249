"""Classifier preprocess (``ClassifierEngine._step``'s ``_preprocess``: K1
in bf16, the float64 exact resize in parity): the mean device milliseconds
of its ``classify.preprocess`` span, between CUDA events recorded on its
stream."""

import statistics

from portbench.program_spans import named


def read(run, ctx):
    steps = [s.device_ms for s in named(run, "classify.preprocess") if s.device_ms is not None]
    return statistics.fmean(steps) if steps else None
