"""Streaming cell engine (the flush queue): the mean milliseconds from a
band's ``flush.enqueue`` span's end on the main thread to the start of its
``flush.band`` span on a flusher (its child, by the parent id the queue's
job carries)."""

import statistics

from portbench.program_spans import window_spans


def read(run, ctx):
    spans = window_spans(run) or []
    enqueued = {s.id: s for s in spans if s.name == "flush.enqueue"}
    waits = [(s.start_ns - enqueued[s.parent].end_ns) / 1e6
             for s in spans if s.name == "flush.band" and s.parent in enqueued]
    return statistics.fmean(waits) if waits else None
