"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``,
found by the metric's name: ``read(run, ctx)`` returns the number, or None
where the run holds nothing to read (the harness then leaves it out)."""
