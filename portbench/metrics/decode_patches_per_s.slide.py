"""Slide decode (``engine/data.PatchBatchSource``'s pool): the patches its
``decode.shard`` spans decoded (their counts) over the spans' summed
seconds: the rate of one decode thread."""

from portbench.program_spans import named


def read(run, ctx):
    shards = named(run, "decode.shard")
    seconds = sum(s.end_ns - s.start_ns for s in shards) / 1e9
    return sum(s.n for s in shards) / seconds if seconds else None
