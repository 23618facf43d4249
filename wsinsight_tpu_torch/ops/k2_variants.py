"""Time builds of K2's CUDA source side by side on one card.

    python -m wsinsight_tpu_torch.ops.k2_variants [NAME=PATH] ...

Each argument names one build of a ``window_attention.cu``: this checkout's
(an empty PATH) or another version of it, e.g. a parent commit's file
unpacked by ``git archive``. With no argument, this checkout's alone. Every
build exports ``wsi_window_attention`` (every row); a shape with real rows
(``valid``) goes to ``wsi_window_attention_rows`` in the builds that have
it and to every row in older ones. The wrapper's checks are not run.

For each shape below, every build is held against the plain version
(``window_attention_reference``, at ``K2_TOL``, on the real rows) and timed
with CUDA events over 20 launches, in turns (first to last, then last to
first; the mean of the two), so that builds compare within one call on one
card. Prints the card's name and power limit, each build's registers and
spills, a line per shape and build, and last one JSON object; exits 1 if a
build fails a check. Launches here are not counted in ``window_attention.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import cuda_build
from .flash_attn import _SOURCE, bind, launch, window_attention_reference

# (name, qkv grid HP x WP, dim, heads, window, rel-pos, B, dtype, valid):
# the cell path's K2 shapes at B=32 in both dtypes (SAM-H windowed with its
# real 16x16 extent, as the model launches it, and at every row; without
# rel-pos in bf16, to price the rel-pos work), and SAM-B's global block at
# 1024 px.
SHAPES = (
    ("sam_h_windowed", (28, 28), 1280, 16, 14, True, 32, torch.bfloat16, None),
    ("sam_h_windowed_norel", (28, 28), 1280, 16, 14, False, 32, torch.bfloat16, None),
    ("sam_h_global", (16, 16), 1280, 16, 0, True, 32, torch.bfloat16, None),
    ("vit_256", (1, 257), 384, 6, 0, False, 32, torch.bfloat16, None),
    ("sam_b_1024_global", (64, 64), 768, 12, 0, True, 1, torch.bfloat16, None),
    ("sam_h_windowed_real", (28, 28), 1280, 16, 14, True, 32, torch.float32, (16, 16)),
    ("sam_h_windowed", (28, 28), 1280, 16, 14, True, 32, torch.float32, None),
    ("sam_h_global", (16, 16), 1280, 16, 0, True, 32, torch.float32, None),
    ("vit_256", (1, 257), 384, 6, 0, False, 32, torch.float32, None),
)
K2_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (5e-2, 5e-2)}
REPS = 20


def build(variants: dict[str, Path], bind=bind) -> dict:
    """Compile every build at once (one nvcc each); returns the libraries,
    each passed through ``bind`` (K2's by default)."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        target = out_dir / f"lib{name}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(target), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), target)
    libs = {}
    for name, (proc, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in cuda_build.ptxas_summary(log):
            print(f"  {name}: {line}")
        libs[name] = bind(ctypes.CDLL(str(target)))
    return libs


def inputs(shape, dim, heads, window, rel, dtype, b, rng):
    (hp, wp), hd = shape, dim // heads
    qkv = torch.from_numpy(rng.standard_normal((b, hp, wp, 3 * dim), dtype=np.float32))
    qkv = qkv.to("cuda", dtype)
    if not rel:
        return qkv, None, None
    tables = []
    for a in (window or hp, window or wp):
        table = rng.standard_normal((2 * a - 1, hd), dtype=np.float32) * 0.5
        idx = np.add.outer(np.arange(a), -np.arange(a)) + a - 1
        tables.append(torch.from_numpy(table[idx]).to("cuda", dtype))
    return qkv, tables[0], tables[1]


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parse(args: list[str]) -> dict[str, Path]:
    this = cuda_build.CSRC_DIR / _SOURCE
    variants = {}
    for arg in args or ["this="]:
        name, _, path = arg.partition("=")
        variants[name] = Path(path) if path else this
    return variants


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("k2_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    variants = parse(argv)
    libs = build(variants)
    rng = np.random.default_rng(0)
    results, failed = [], []
    for name, shape, dim, heads, window, rel, b, dt, valid in SHAPES:
        qkv, rh, rw = inputs(shape, dim, heads, window, rel, dt, b, rng)
        scale = (dim // heads) ** -0.5
        h, w = valid or shape
        want = window_attention_reference(qkv, heads, window, scale, rh, rw)[:, :h, :w].float()
        atol, rtol = K2_TOL[dt]
        outs = {v: torch.empty((b, *shape, dim), dtype=dt, device="cuda") for v in libs}
        rows = {v: valid if hasattr(lib, "wsi_window_attention_rows") else None
                for v, lib in libs.items()}
        calls = {v: (lambda lib=lib, o=outs[v], r=rows[v]:
                     launch(lib, qkv, o, heads, window, scale, rh, rw, r))
                 for v, lib in libs.items()}
        errs = {}
        for v, call in calls.items():
            call()
            torch.cuda.synchronize()
            diff = (outs[v][:, :h, :w].float() - want).abs()
            errs[v] = float(diff.max())
            if float((diff - atol - rtol * want.abs()).max()) > 0:
                failed.append(f"{v} {name} {str(dt)[6:]}")
        order = list(calls)
        times = {v: [] for v in order}
        for v in order + order[::-1]:
            times[v].append(cuda_ms(calls[v]))
        for v in order:
            ms = sum(times[v]) / len(times[v])
            span = "real rows" if rows[v] else "every row"
            results.append({"build": v, "shape": name, "b": b, "dtype": str(dt)[6:], "ms": ms,
                            "rows": span, "ms_each": times[v], "max_abs_err": errs[v]})
            print(f"  {name} B={b} {str(dt)[6:]} {v} ({span}): {ms * 1e3:.1f} us"
                  f" ({', '.join(f'{t * 1e3:.1f}' for t in times[v])}), max |d| {errs[v]:.3g}")
        del qkv, rh, rw, want, outs
        torch.cuda.empty_cache()
    for f in failed:
        print(f"  FAIL: {f} exceeds K2_TOL", file=sys.stderr)
    print(json.dumps({"card": card, "builds": {v: str(p) for v, p in variants.items()},
                      "rows": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
