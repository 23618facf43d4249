#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``), whose ``driver`` (``drivers/<driver>.py``) makes
the inputs and the weights from ``--seed``, sets up and warms the port,
runs the window for ``--seconds`` and returns what it saw. Each metric of
the cell is read by ``metrics/<metric>.py``: with ``--trace 0`` the
end-to-end ones, with ``--trace 1`` the per-layer ones, in a run that
traces part of the window with torch.profiler. Then the program's state is
freed and the mix's ``check`` holds the window's outputs against the plain
reference (``reference/``); each number compared is printed beside its
limit, as the last lines of standard error and under ``checked``, the last
key of the result.

The last line of standard output is the result, one JSON object. Without a
CUDA card (or with fewer than the cell asks for), with a JAX module loaded,
or without the port beside it, the run exits non-zero and prints none.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every kernel and build cache inside the checkout, at fixed paths (the
    port's own kernels build into build/wsinsight_tpu_torch/)."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(args, bench: dict, device) -> types.SimpleNamespace:
    """The cell's configuration, traffic and run settings, as drivers and
    metric readers see them."""
    from portbench.common import BENCH_DIR, Spans, load_json

    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"run.py: no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return types.SimpleNamespace(
        workload=args.workload, cell=cell, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), config=load_json(ROOT / entry["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        device=device, peaks=None, setup_spans=Spans())


def metrics_of(bench: dict, ctx, run: dict) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer ones
    (traced run), each read by its own file; a reader that finds nothing
    leaves its metric out."""
    from portbench.common import load_module, reader_path

    kind = "per_layer" if ctx.trace else "end_to_end"
    out = {}
    for m in bench[kind]:
        if "workloads" in m and ctx.workload not in m["workloads"]:
            continue
        reader = load_module(reader_path(m["name"]),
                             "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run, ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(ctx, bench: dict, kind: str, started: float) -> dict | None:
    """Set up, run the window, free the program, check its outputs and read
    the metrics: the result's object, or None where a JAX module was
    loaded. ``started`` is the process's start on the host clock. The
    set-up's seconds leave out the drivers' ``calibrate`` spans: the plain
    reference's forwards that set the seeded weights' heads, which are the
    benchmark's work and not the program's."""
    from portbench.common import forbidden_modules, stderr

    driver = importlib.import_module(f"portbench.drivers.{ctx.traffic['driver']}")
    state = driver.setup(ctx)
    total = time.time() - started
    stages: dict[str, float] = {}
    for name, a, b in ctx.setup_spans.items:
        stages[name] = stages.get(name, 0.0) + (b - a)
    stages["other"] = total - sum(stages.values())
    setup_s = total - stages.get("calibrate", 0.0)
    stderr("set-up stages (s): " + json.dumps(stages))
    run = driver.window(state, ctx)
    run["setup_s"] = setup_s
    driver.free(state, ctx)
    numbers = driver.check(state, run, ctx)

    bad = forbidden_modules(list(sys.modules))
    if bad:
        stderr(f"run.py: JAX or the JAX package was loaded: {', '.join(bad)}")
        return None
    if ctx.trace and run.get("trace") is None:
        raise RuntimeError("the traced run holds no trace")
    limits = ctx.config["limits"]
    checked = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    device = {"platform": "gpu", "kind": kind, "count": ctx.cell["chips"],
              "memory_peak_bytes": int(run["peak_bytes"])}
    result = {"correct": all(c["value"] <= c["limit"] for c in checked.values()),
              "attempted": int(run["attempted"]), "failed": int(run["failed"]),
              "metrics": metrics_of(bench, ctx, run), "device": device}
    if ctx.trace:
        device.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
        result["breakdown"] = {k: run["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checked"] = checked
    stderr("reported, not compared: " + json.dumps(
        {k: v for k, v in numbers.items() if k not in limits}))
    return result


def main(argv=None) -> int:
    import psutil

    started = psutil.Process().create_time()
    marks = [("python_start", started, time.time())]  # the set-up's first stages
    args = parse(argv)
    os.environ["WSINSIGHT_STREAM_PROFILE"] = "1" if args.trace else "0"  # read at the port's import
    os.environ.setdefault("USE_FLAX", "0")
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from portbench.common import load_json, peaks_for, stderr

    t0 = time.time()
    import torch

    marks.append(("import_torch", t0, time.time()))
    bench = load_json(ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        stderr("run.py: torch.cuda.is_available() is false: the benchmark runs on a CUDA card only")
        return 2
    ctx = context(args, bench, torch.device("cuda", 0))
    if torch.cuda.device_count() < ctx.cell["chips"]:
        stderr(f"run.py: {args.workload} needs {ctx.cell['chips']} card(s), the process sees"
               f" {torch.cuda.device_count()}")
        return 2
    t0 = time.time()
    try:
        import wsinsight_tpu_torch  # noqa: F401
    except ImportError as err:
        stderr(f"run.py: the port is not importable ({err}); run from the root of a checkout")
        return 1
    marks.append(("import_port", t0, time.time()))
    ctx.setup_spans.items.extend(marks)  # only their lengths are read
    kind = torch.cuda.get_device_name(0)
    ctx.peaks = peaks_for(kind)
    result = run_cell(ctx, bench, kind, started)
    if result is None:
        return 3
    for name, c in result["checked"].items():
        stderr(f"checked {name} {c['value']!r} limit {c['limit']!r}"
               f" {'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
