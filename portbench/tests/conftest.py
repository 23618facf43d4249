"""Shared fixtures of the benchmark's own tests: small cells on the CPU, and
the one card where a test needs it (decided here, never at import)."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def small_cell(tmp_path, monkeypatch):
    """A function making the context of a cell of BENCHMARK.json cut to run
    on the CPU in seconds: its seeded slide in ``tmp_path`` and smaller; the
    widths and limits as the cell has them unless ``config`` says other."""
    import torch

    import portbench.slides as slides
    from portbench.common import PEAKS, load_json
    from portbench.run import context

    monkeypatch.setattr(slides, "CACHE_DIR", tmp_path)

    def make(workload: str, seconds: float = 0.5, config=None, traffic=None, seed=2**31 + 17):
        bench = load_json(ROOT / "BENCHMARK.json")
        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
        ctx = context(args, bench, torch.device("cpu"))
        ctx.peaks = PEAKS["H100 80GB HBM3"]
        for key, value in (config or {}).items():
            ctx.config[key] = value
        for key, value in (traffic or {}).items():
            ctx.traffic[key] = value
        return ctx, bench

    return make
