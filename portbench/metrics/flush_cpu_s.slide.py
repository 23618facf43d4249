"""Host tail (``BandedCellStitcher._flush_band`` on the flushers): the
flushers' thread CPU seconds in their ``flush.band`` spans, per slide of
the window."""

from portbench.program_spans import named


def read(run, ctx):
    bands = named(run, "flush.band")
    return sum(s.cpu_ns for s in bands) / 1e9 / len(run["slides"]) if bands else None
