"""Patches of every slide finished in the window over the window's wall
time; the window holds whole slides, from the first one's plan to the last
one's instances."""


def read(run, ctx):
    return run["patches"] / run["window_s"]
