"""Host -> device copy (``engine/runner.Replicated.put``): the milliseconds
of its ``put.pin`` spans (the batch copied into page-locked memory) per
``engine.put``."""

from portbench.program_spans import named


def read(run, ctx):
    puts, pins = named(run, "engine.put"), named(run, "put.pin")
    return sum(s.end_ns - s.start_ns for s in pins) / 1e6 / len(puts) if pins and puts else None
