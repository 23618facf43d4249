"""Slide planning (``patchlib/pipeline.plan_slide``): mean host seconds of
the benchmark's span around each slide's call."""

import statistics


def read(run, ctx):
    plans = run["spans"].durations("plan")
    return statistics.fmean(plans) if plans else None
