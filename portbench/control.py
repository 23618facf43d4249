#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, a short window of the program held against
the reference (the lower reading), and the control held against it (the
upper reading): the reference in fp8 in the program's place (``--control
fp8``), or the program with its own TF32 path on (``--control tf32``,
WSINSIGHT_PRECISION=default, for a float32 configuration with TF32 off).

    python3 portbench/control.py --workload <name> --control fp8|tf32 --seconds <s> --seeds <n> ...

One JSON line per seed. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", choices=("fp8", "tf32"), required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.common import load_json, peaks_for
    from portbench.run import _cache_dirs, context

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    _cache_dirs()
    bench = load_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds, trace=0)
        ctx = context(ns, bench, torch.device("cuda", 0))
        ctx.peaks = peaks_for(torch.cuda.get_device_name(0))
        driver = importlib.import_module(f"portbench.drivers.{ctx.traffic['driver']}")
        line = {"seed": seed}
        for side in ("lower", "upper"):
            if side == "upper" and args.control == "fp8":
                line[side] = driver.check(state, run, ctx, control="fp8")
                continue
            if side == "upper":
                os.environ["WSINSIGHT_PRECISION"] = "default"
            try:
                state = driver.setup(ctx)
                run = driver.window(state, ctx)
                driver.free(state, ctx)
            finally:
                os.environ.pop("WSINSIGHT_PRECISION", None)
            line[side] = driver.check(state, run, ctx)
        print(json.dumps(line), flush=True)
        del state, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
