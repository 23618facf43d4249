"""Streaming cell engine (``engine/stream_cells.stream_slide``): the share
of the main thread's ``stream.batch`` wall time (put, dispatch, accumulate
and the bands' enqueue of each batch) spent off its CPU, waiting for the
GIL or blocked: 100 x (wall - thread CPU) / wall, from the program's
spans."""

from portbench.program_spans import named


def read(run, ctx):
    batches = named(run, "stream.batch")
    wall = sum(s.end_ns - s.start_ns for s in batches)
    return 100.0 * (wall - sum(s.cpu_ns for s in batches)) / wall if wall else None
