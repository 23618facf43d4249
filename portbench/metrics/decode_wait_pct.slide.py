"""Slide decode (``engine/data.PatchBatchSource``): the main thread's host
seconds blocked in the batch iterator's ``next``, as a share of the
window's wall time."""

from portbench.common import window_s


def read(run, ctx):
    waits = run["spans"].durations("decode_wait")
    return 100.0 * sum(waits) / window_s(run) if waits else None
