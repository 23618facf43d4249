"""Device: the share of the traced stretch (one whole slide, or some
seconds of a classifier's window) in which no kernel, copy or set ran on
the card, from the torch.profiler trace. Reads ``device_idle_pct.slide``
and ``device_idle_pct.step``."""


def read(run, ctx):
    trace = run["trace"]
    if trace is None:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
