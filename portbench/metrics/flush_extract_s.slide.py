"""Host tail (``ops/hv_postproc`` on the flushers): the library's
``hot_stage`` ``flush.extract_instances`` seconds (summed over the flusher
threads) per slide of the window; the stage timers run in the traced run
only (WSINSIGHT_STREAM_PROFILE=1)."""


def read(run, ctx):
    seconds = run.get("hot_stages", {}).get("flush.extract_instances")
    return seconds / len(run["slides"]) if seconds else None
