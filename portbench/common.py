"""What every driver and metric reader of the benchmark shares: paths, the
card's peaks, the host-clock spans, the reading of a torch.profiler trace,
seeded weights made on the card, and the check that no JAX module was
loaded. Imports nothing of the port, nothing of JAX."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Seeded slides, written once per checkout and reused by later runs (git-ignored).
CACHE_DIR = BENCH_DIR / ".cache"

# Published dense peaks of the card (NVIDIA's data sheet, H100 SXM5 at its 700 W
# limit): bytes/s of HBM, float32 FLOP/s outside the tensor cores, bf16 and TF32
# FLOP/s on the tensor cores. Matched by a part of torch.cuda.get_device_name().
PEAKS = {
    "H100 80GB HBM3": {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12, "tf32": 494.7e12},
}

# Top-level module names that the port's process must never hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "wsinsight_tpu")


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name`` (drivers and metric
    readers are found by the names in ``BENCHMARK.json``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_path(metric: str) -> Path:
    """The reader of ``metric``: ``metrics/<metric>.py``, or where there is
    none, the reader of the quantity it splits per end-to-end metric
    (``device_idle_pct.slide`` -> ``metrics/device_idle_pct.py``)."""
    own = BENCH_DIR / "metrics" / f"{metric}.py"
    return own if own.is_file() else BENCH_DIR / "metrics" / f"{metric.split('.', 1)[0]}.py"


def forbidden_modules(names) -> list[str]:
    """The module names among ``names`` whose top-level name (the part before
    the first dot) is one of FORBIDDEN_MODULES, compared whole: a module of
    ``wsinsight_tpu_torch`` is not one of ``wsinsight_tpu``'s."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def peaks_for(kind: str) -> dict:
    for part, peaks in PEAKS.items():
        if part in kind:
            return peaks
    raise RuntimeError(f"no published peaks for {kind!r}; add the card to common.PEAKS")


def sync(device) -> None:
    """Wait for the card (a CPU device has nothing to wait for)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """The card's peak of allocated bytes since the last reset_peak."""
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def warm_libraries(device) -> None:
    """Create the card's cuBLAS and cuDNN handles (a small matmul and
    convolution), so that set-up pays for them before the weights'
    calibration, whose seconds it leaves out."""
    import torch

    x = torch.ones((1, 8, 16, 16), device=device)
    torch.nn.functional.conv2d(x, torch.ones((8, 8, 3, 3), device=device))
    x.view(16, -1) @ x.view(-1, 16)
    sync(device)


def free_cache(device) -> None:
    import torch

    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Spans:
    """Host-clock spans of the benchmark's own calls into the port's layers:
    (name, start, end) in ``time.perf_counter`` seconds, and the same on the
    Unix clock in nanoseconds (``ns``), the clock of torch.profiler's
    events, so that the trace's idle gaps can be named by what the host was
    doing."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.ns: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        n0, t0 = time.time_ns(), time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))
            self.ns.append((name, n0, time.time_ns()))

    def total(self, name: str) -> float:
        return sum(b - a for n, a, b in self.items if n == name)

    def durations(self, name: str) -> list[float]:
        return [b - a for n, a, b in self.items if n == name]


class Tracer:
    """torch.profiler, CUDA activity only (no per-op host records, whose
    cost would move what is measured), over part of a window. It starts
    before the window, so the profiler's own start-up stays out of it;
    ``begin`` and ``end`` mark the traced stretch on the Unix clock; the
    profiler stops at ``end``, and its stop, inside the window, is the span
    ``trace_stop``, which the window's shares leave out. With ``enabled``
    false every call does nothing."""

    def __init__(self, enabled: bool, spans: Spans, device):
        self.spans, self.device, self.prof, self.trace = spans, device, None, None
        self.begin_ns = 0
        self.state = "off"
        if enabled:
            import torch

            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.state = "ready"

    def begin(self) -> None:
        if self.state == "ready":
            self.begin_ns = time.time_ns()
            self.state = "tracing"

    def end(self) -> None:
        if self.state != "tracing":
            return
        sync(self.device)
        end_ns = time.time_ns()
        with self.spans("trace_stop"):
            self.prof.stop()
            self.trace = read_trace(self.prof, self.spans, self.begin_ns, end_ns)
        self.state = "done"


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_trace(prof, spans: Spans, w0: int, w1: int) -> dict:
    """The card's activity in a stopped torch.profiler run between the Unix
    times ``w0`` and ``w1`` (ns): the stretch's length (``window_s``), the
    seconds in which any kernel, copy or set ran (``busy_s``), the device
    operations by total seconds, the idle gaps named by the innermost host
    span around each gap's middle, and per kernel name its launches and
    seconds."""
    inside = []
    for ev in prof.profiler.kineto_results.events():
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if b > w0 and a < w1:
            inside.append((ev.name(), max(a, w0), min(b, w1)))
    if not inside:
        raise RuntimeError("the trace holds no device operation in the traced stretch")
    merged = _merge([(a, b) for _, a, b in inside])
    by_name: dict[str, list[float]] = {}
    for n, a, b in inside:
        rec = by_name.setdefault(n, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) / 1e9
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        around = [h for h in spans.ns if h[1] <= mid <= h[2]]
        label = min(around, key=lambda h: h[2] - h[1])[0] if around else "other"
        gaps.append((label, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(((n, s) for n, (_, s) in by_name.items()), key=lambda o: -o[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in merged) / 1e9,
        "device_ops": [[n[:64], s] for n, s in ops[:10]],
        "idle_gaps": [[n, s] for n, s in gaps[:10]],
        "kernels": {n: {"launches": c, "seconds": s} for n, (c, s) in by_name.items()},
    }


def window_s(run: dict) -> float:
    """The window's wall time less the profiler's stop inside it."""
    return run["window_s"] - run["spans"].total("trace_stop")


def kernel_time(trace: dict, part: str) -> tuple[int, float]:
    """(launches, seconds) of the trace's kernels whose name holds ``part``."""
    hits = [v for n, v in trace["kernels"].items() if part in n]
    return sum(v["launches"] for v in hits), sum(v["seconds"] for v in hits)


# Variance x fan-in of the seeded convolutions: He's gain, which keeps the
# activations' scale through a ReLU network.
CONV_GAIN = 2.0


def seeded_state_dict(meta_model, seed: int, device) -> dict:
    """Seeded weights for ``meta_model`` (the architecture built on the meta
    device, so only its names and shapes are read), made on ``device`` in
    float32 by one ``torch.Generator`` in one call per distribution: linear
    weights normal with variance 1/fan-in, convolutions CONV_GAIN/fan-in,
    transposed convolutions 1/in-channels, biases N(0, 0.1^2), position
    embeddings N(0, 0.02^2), rel-pos tables N(0, 0.1^2), LayerScale gains
    U[0.1, 1]; layer and batch norms keep their identity. The same seed
    gives the same weights."""
    import torch
    from torch import nn

    sd = meta_model.state_dict()
    normal, uniform, fixed = [], [], {}
    for key, t in sd.items():
        mod_name, _, leaf = key.rpartition(".")
        mod = meta_model.get_submodule(mod_name) if mod_name else meta_model
        if isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            value = 1.0 if leaf in ("weight", "running_var") else 0.0
            fixed[key] = torch.full(t.shape, value, dtype=t.dtype, device=device)
        elif leaf == "bias":
            normal.append((key, t.shape, 0.1))
        elif isinstance(mod, nn.ConvTranspose2d):
            normal.append((key, t.shape, (1.0 / t.shape[0]) ** 0.5))
        elif leaf == "weight":
            gain = CONV_GAIN if t.dim() == 4 else 1.0
            normal.append((key, t.shape, (gain / t[0].numel()) ** 0.5))
        elif leaf == "gamma":
            uniform.append((key, t.shape, None))
        else:
            normal.append((key, t.shape, 0.1 if leaf.startswith("rel_pos") else 0.02))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = dict(fixed)
    for items, draw in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(int(torch.Size(s).numel()) for _, s, _ in items)
        if not total:
            continue
        flat = draw(total, generator=gen, device=device, dtype=torch.float32)
        offset = 0
        for key, shape, std in items:
            n = int(torch.Size(shape).numel())
            view = flat[offset:offset + n].view(shape)
            if std is None:
                view.mul_(0.9).add_(0.1)
            else:
                view.mul_(std)
            out[key] = view
            offset += n
    return {k: out[k] for k in sd}


class Weights:
    """A model handle for the port's engines (``config`` and
    ``load_state_dict``) that hands over the benchmark's own state dict."""

    def __init__(self, config, state_dict: dict):
        self.config = config
        self.state_dict = state_dict
        self.name = "portbench"

    def load_state_dict(self, model=None) -> dict:
        return self.state_dict


def stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)
