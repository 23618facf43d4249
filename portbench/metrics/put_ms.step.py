"""Host -> device copy (``engine/runner.Replicated.put``): mean host
milliseconds of each ``put`` (pinning the batch and enqueueing its copy)."""

import statistics


def read(run, ctx):
    return 1e3 * statistics.fmean(run["puts"]) if run["puts"] else None
