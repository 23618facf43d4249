"""Device: ``torch.cuda.max_memory_allocated`` over the window, the peak
reset at its start, in GiB. Reads ``peak_device_gib.slide`` and
``peak_device_gib.step``."""


def read(run, ctx):
    return run["peak_bytes"] / 2**30
