"""Streaming engine (``engine/stream_cells``): mean host seconds per slide
from the return of ``stream_slide`` (the last batch dispatched) to the
return of ``finalize``."""

import statistics


def read(run, ctx):
    tails = run["spans"].durations("finalize")
    return statistics.fmean(tails) if tails else None
