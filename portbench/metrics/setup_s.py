"""Set-up: host seconds from the process's start (its creation time) to the
window's start: imports, the CUDA context, kernel loading (or their build,
on a checkout's first run), the seeded slide (written on the first run),
the weights, the engine and the warm-up."""


def read(run, ctx):
    return run["setup_s"]
