"""Drivers, one per kind of traffic, found by the ``driver`` a traffic file
names: ``setup(ctx)``, ``window(state, ctx)``, ``free(state)`` and
``check(state, run, ctx, control=None)``."""
