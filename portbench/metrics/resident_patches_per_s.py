"""Patches whose probabilities reached host memory over the window's wall
time."""


def read(run, ctx):
    return run["patches"] / run["window_s"]
