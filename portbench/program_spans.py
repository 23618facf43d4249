"""The program's own spans over a run's window, for the per-layer metrics
that read them: ``wsinsight_tpu_torch.utils.profiling.spans()``, on in a
traced run (``WSINSIGHT_STREAM_PROFILE=1``), each with its name, id,
parent, thread, start and end on the Unix clock (ns), thread CPU ns, count
``n`` and, for a span timed on the card, ``device_ms``."""

from __future__ import annotations


def window_spans(run: dict) -> list | None:
    """The spans that start inside the window: from the first start among
    the benchmark's own spans (``run["spans"].ns``) to that plus
    ``run["window_s"]``. None where the program records none (spans off, or
    a program without the recorder) or where its buffer dropped any."""
    try:
        from wsinsight_tpu_torch.utils import profiling
    except ImportError:
        return None
    read, dropped = getattr(profiling, "spans", None), getattr(profiling, "dropped", None)
    if read is None or dropped is None or dropped() or not run["spans"].ns:
        return None
    w0 = min(a for _, a, _ in run["spans"].ns)
    w1 = w0 + run["window_s"] * 1e9
    inside = [s for s in read() if w0 <= s.start_ns < w1]
    return inside or None


def named(run: dict, name: str) -> list:
    """The window's spans called ``name`` (empty where there are none)."""
    return [s for s in window_spans(run) or () if s.name == name]
