"""Host-pressure-aware pool sizing and throttling.

Every stage of the pipeline fans out onto host CPU pools (patch decode,
exporters, stitch tiles, analytics workers) while the device engine runs
asynchronously; the host is therefore the contended resource, and pools
sized statically oversubscribe it. This module serves the same purpose as
the reference's governor (reference: wsinsight/num_worker_optimizer.py),
designed here around a small ``HostLoadMonitor`` that other code can also
query directly.

Sizing model: a pool gets the minimum of
  * a CPU budget  — cores currently idle, scaled so the whole host settles
    at ``cpu_target`` utilisation and one core stays reserved for the
    engine's dispatch thread, and
  * a RAM budget  — bytes available above a safety floor divided by the
    per-worker footprint (measured, caller-supplied, or a conservative
    fraction fallback),
clamped to [min_workers, max_workers]. Repeated calls smooth the samples
exponentially so a momentary spike doesn't collapse the pool.

``psutil`` is imported where it is used, so the module imports without it;
where it is missing, ``governed_workers`` returns the request unchanged.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


def _core_count() -> int:
    import psutil

    physical = psutil.cpu_count(logical=False)
    return physical if physical else (os.cpu_count() or 1)


@dataclass
class HostLoadMonitor:
    """Samples CPU/RAM utilisation with exponential smoothing."""

    smoothing: float = 0.5
    _cpu: Optional[float] = field(default=None, repr=False)
    _mem: Optional[float] = field(default=None, repr=False)

    def _blend(self, old: Optional[float], new: float) -> float:
        if old is None:
            return new
        return self.smoothing * new + (1.0 - self.smoothing) * old

    def sample(self, interval: float = 0.3) -> tuple[float, float, int]:
        """(smoothed cpu frac, smoothed mem frac, available bytes)."""
        import psutil

        cpu = psutil.cpu_percent(interval=interval) / 100.0
        vm = psutil.virtual_memory()
        self._cpu = self._blend(self._cpu, cpu)
        self._mem = self._blend(self._mem, vm.percent / 100.0)
        return self._cpu, self._mem, vm.available

    def footprint_of(self, work: Callable[[], None], settle: float = 0.1) -> Optional[int]:
        """RSS growth from one representative unit of work, padded 1.5x."""
        import psutil

        me = psutil.Process(os.getpid())
        rss0 = me.memory_info().rss
        start = time.time()
        try:
            work()
        except Exception:
            pass
        remaining = settle - (time.time() - start)
        if remaining > 0:
            time.sleep(remaining)
        grown = me.memory_info().rss - rss0
        return int(grown * 1.5) if grown > 0 else None


_MONITOR = HostLoadMonitor()


def pick_workers_safe(
    target_cpu_util: float = 0.60,
    target_mem_util: float = 0.75,
    max_workers: int = 32,
    min_workers: int = 2,
    *,
    memory_per_worker_bytes: Optional[int] = None,
    reserve_mem_bytes: int = 512 * 1024 * 1024,
    cpu_core_reserve: int = 1,
    sample_interval_sec: float = 0.30,
    ewma_alpha: float = 0.5,
    dynamic_probe_fn: Optional[Callable[[], None]] = None,
) -> int:
    """Worker count from current CPU idle capacity and RAM headroom."""
    max_workers = max(1, int(max_workers))
    _MONITOR.smoothing = ewma_alpha
    cpu_frac, mem_frac, avail_bytes = _MONITOR.sample(sample_interval_sec)

    usable_cores = max(1, _core_count() - cpu_core_reserve)
    cpu_budget = int(usable_cores * max(0.0, target_cpu_util - cpu_frac))

    footprint = memory_per_worker_bytes
    if footprint is None and dynamic_probe_fn is not None:
        footprint = _MONITOR.footprint_of(dynamic_probe_fn)
    spendable = max(0, avail_bytes - reserve_mem_bytes)
    if footprint:
        ram_budget = spendable // footprint
    else:
        # No footprint estimate: treat the distance to the memory target as
        # the fraction of the pool we may still open.
        ram_budget = min(usable_cores, int(max(0.0, target_mem_util - mem_frac) * max_workers))

    budget = min(cpu_budget, ram_budget, usable_cores, max_workers)
    if budget <= 0:
        # Host is saturated. With a known footprint, still honour the hard
        # RAM cap so min_workers can't overcommit memory — but never go
        # below 1: callers hand the result straight to pool constructors,
        # which reject max_workers=0, and one worker is the liveness floor.
        if footprint:
            return int(max(1, min(spendable // footprint, min_workers)))
        return max(1, min_workers)
    return max(1, min_workers, int(budget))


def governed_workers(requested: int, max_workers: int = 32) -> int:
    """Clamp a requested pool size by current host headroom.

    The reference applies its adaptive sizing to EVERY pool — geojson,
    omecsv, hplot, cme (reference: num_worker_optimizer.py:74-165,
    write_geojson.py:459); this is the one-line entry those pools call here.
    Never exceeds `requested` (the user's explicit knob stays a hard cap).
    """
    requested = max(1, int(requested))
    try:
        safe = pick_workers_safe(max_workers=min(requested, max_workers), min_workers=1)
    except Exception:  # psutil missing or failing: fall back to the static request
        return requested
    return max(1, min(requested, safe))
