#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wsinsight_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main path, patch classification with the zoo model
breast-tumor-resnet34.tcga-brca at full width (350 px patches, resize 224,
ResNet34, 2 classes, seeded random weights), and holds every hand-written
kernel against its plain torch version. Phases; any failure exits non-zero
and prints no result line:

  (a) the card's name and power limit; no CUDA -> exit 1;
  (b) build every kernel from the checkout's sources (one nvcc per source);
  (c) K1 (fused uint8 -> PIL resize -> normalize) vs its plain version on the
      card, f32 and bf16, at B=256 350->224, B=256 175->224 and B=3 97->64;
      K1's time over >= 20 launches (CUDA events) beside its bound;
  (d) ClassifierEngine in parity (fp32, TF32 off, exact resize) and in
      mixed_precision (bf16, K1): 20 batches of B=256 through put -> dispatch
      with the two-deep window of run_inference; patches/s, peak memory, and
      the kernels' launch counts over that run;
  (e) parity on the card vs the same engine on the CPU (8 patches, 1e-3),
      mixed vs parity (0.01), every row finite and summing to 1.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from collections import deque

import numpy as np

MODEL = "breast-tumor-resnet34.tcga-brca"
N_BATCHES = 20
BATCH = 256
SEED = 0

# Data-sheet rates by card name: (bytes/s, fp32 FLOP/s outside the tensor cores).
CARD_RATES = {
    "H100 80GB HBM3": (3.35e12, 67e12),  # H100 SXM
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H200": (4.8e12, 67e12),
}


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

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


class Checks:
    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)


def k1_bound(b, h, w, oh, ow, out_bytes, rates):
    """(least ms, what bounds it) for K1: input read once, output written
    once; 2 FLOP per tap of each pass plus the affine, at fp32 peak."""
    from wsinsight_tpu_torch.ops.fused_preprocess import _band

    bw, flops_peak = rates
    nbytes = b * h * w * 3 + b * oh * ow * 3 * out_bytes
    taps_h = int(_band(w, ow)[1].sum())
    taps_v = int(_band(h, oh)[1].sum())
    flops = 2 * b * 3 * (h * taps_h + ow * taps_v) + 2 * b * oh * ow * 3
    t_bytes, t_ops = nbytes / bw * 1e3, flops / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    # (a) ------------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.ops import cuda_build
    from wsinsight_tpu_torch.ops.fused_preprocess import (
        fused_preprocess,
        fused_preprocess_reference,
    )
    from wsinsight_tpu_torch.ops.preprocess import TransformSpec
    from wsinsight_tpu_torch.zoo import ModelHandle, get_registered_model, make_random_local_model

    card = _smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    rates = next((r for k, r in CARD_RATES.items() if k in kind), CARD_RATES["H100 80GB HBM3"])
    print(card)
    print(f"(a) torch {torch.__version__} CUDA {torch.version.cuda}; {kind};"
          f" data-sheet rates {rates[0] / 1e12:.2f} TB/s, fp32 {rates[1] / 1e12:.0f} TFLOP/s")
    check = Checks()
    dev = torch.device("cuda", 0)
    kernels = {fused_preprocess: "fused_preprocess"}

    # (b) ------------------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"(b) built {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    # (c) ------------------------------------------------------------------
    handle = get_registered_model(MODEL)
    spec = TransformSpec.from_config(handle.config.transform)
    std = np.asarray(spec.std, np.float32)
    scale = 1.0 / (255.0 * std)
    shift = -np.asarray(spec.mean, np.float32) / std
    rng = np.random.default_rng(SEED)
    print(f"(c) K1 vs its plain version ({MODEL} mean/std)")
    max_abs_err = 0.0
    for b, h, oh in ((BATCH, 350, 224), (BATCH, 175, 224), (3, 97, 64)):
        x = torch.from_numpy(rng.integers(0, 256, (b, h, h, 3), dtype=np.uint8)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            got = fused_preprocess(x, (oh, oh), scale, shift, dt)
            want = fused_preprocess_reference(x, (oh, oh), scale, shift, dt)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            levels = float((diff / torch.from_numpy(scale).to(dev)).max())
            share = float((got != want).float().mean())
            max_abs_err = max(max_abs_err, float(diff.max()))
            check(
                got.shape == (b, oh, oh, 3) and levels <= 1.0 + 1e-3 and share <= 1e-3,
                f"B={b} {h}->{oh} {str(dt)[6:]}: max diff {levels:.3g} uint8 levels (<= 1),"
                f" share differing {share:.3g} (<= 1e-3)",
            )
    x = torch.from_numpy(rng.integers(0, 256, (BATCH, 350, 350, 3), dtype=np.uint8)).to(dev)
    timing = {}
    for dt, nb in ((torch.bfloat16, 2), (torch.float32, 4)):
        ms = _cuda_ms(lambda: fused_preprocess(x, (224, 224), scale, shift, dt), reps=50)
        plain_ms = _cuda_ms(
            lambda: fused_preprocess_reference(x, (224, 224), scale, shift, dt), reps=5, warmup=1
        )
        bound_ms, bound_by = k1_bound(BATCH, 350, 350, 224, 224, nb, rates)
        timing[dt] = (ms, plain_ms, bound_ms, bound_by)
        print(f"    K1 B={BATCH} 350->224 {str(dt)[6:]}: {ms * 1e3:.1f} us/launch over 50,"
              f" bound {bound_ms * 1e3:.1f} us ({bound_by}, {bound_ms / ms:.1%} of it),"
              f" plain version {plain_ms:.3f} ms; no library call computes it")
    del x

    # (d) ------------------------------------------------------------------
    tmp = tempfile.TemporaryDirectory()
    _, weights = make_random_local_model("resnet34", 2, tmp.name, seed=SEED)
    handle = ModelHandle(name=MODEL, config=handle.config, weights_path=str(weights))
    t0 = time.perf_counter()
    data = rng.integers(0, 256, (N_BATCHES, BATCH, 350, 350, 3), dtype=np.uint8)
    print(f"(d) {N_BATCHES} batches of B={BATCH} seeded 350x350 patches"
          f" ({data.nbytes / 1e9:.2f} GB) made in {time.perf_counter() - t0:.1f} s")
    engines = {m: ClassifierEngine(handle, mixed_precision=m) for m in (False, True)}
    for engine in engines.values():  # warm-up: cuDNN plans, pinned buffers
        engine.run_batch(data[0], BATCH)
    torch.cuda.synchronize()

    for fn in kernels:
        fn.launches = 0
    probs, stats = {}, {}
    for mixed, engine in engines.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pending, outs = deque(), []
        for images in data:
            pending.append(engine.dispatch(engine.put(images)))
            if len(pending) > 2:
                outs.append(pending.popleft().cpu().numpy())
        outs += [p.cpu().numpy() for p in pending]
        secs = time.perf_counter() - t0
        probs[mixed] = np.concatenate(outs)
        stats[mixed] = (N_BATCHES * BATCH / secs, torch.cuda.max_memory_allocated() / 2**30)
    launches = {name: fn.launches for fn, name in kernels.items()}
    for mixed in engines:
        name = "mixed_precision (bf16, K1)" if mixed else "parity (fp32, exact resize)"
        print(f"    {name}: {stats[mixed][0]:.1f} patches/s, peak {stats[mixed][1]:.2f} GiB")
    check(launches["fused_preprocess"] == N_BATCHES,
          f"K1 launches over the main path: {launches['fused_preprocess']}"
          f" (mixed-precision batches: {N_BATCHES})")
    # Device time per stage, one resident batch (CUDA events).
    x = engines[False].put(data[1])
    for mixed, engine in engines.items():
        pre = _cuda_ms(lambda: engine._preprocess(x), reps=10)
        step = _cuda_ms(lambda: engine.dispatch(x), reps=10)
        t0 = time.perf_counter()
        for _ in range(5):
            engine.put(data[1])
        torch.cuda.synchronize()
        put = (time.perf_counter() - t0) / 5 * 1e3
        print(f"    {'mixed' if mixed else 'parity'} per batch: put (host pin + H2D, host clock)"
              f" {put:.2f} ms; device: preprocess {pre:.2f} ms, whole step {step:.2f} ms")
    print(f"    {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")

    # (e) ------------------------------------------------------------------
    print("(e) results")
    cpu_engine = ClassifierEngine(handle, device="cpu")
    cpu = cpu_engine.run_batch(data[0, :8], 8)
    err = float(np.abs(probs[False][:8] - cpu).max())
    check(err <= 1e-3, f"parity on the card vs the CPU, 8 patches: max |dp| {err:.3g} (<= 1e-3)")
    err = float(np.abs(probs[True] - probs[False]).max())
    check(err <= 0.01, f"mixed_precision vs parity, {len(probs[True])} patches:"
          f" max |dp| {err:.3g} (<= 0.01)")
    for mixed, p in probs.items():
        ok = p.shape == (N_BATCHES * BATCH, 2) and bool(np.isfinite(p).all())
        ok = ok and float(np.abs(p.sum(axis=1) - 1.0).max()) <= 1e-5
        check(ok, f"{'mixed' if mixed else 'parity'}: {p.shape} finite, rows sum to 1,"
              f" probabilities in [{p.min():.3f}, {p.max():.3f}]")
    tmp.cleanup()

    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed", file=sys.stderr)
        return 1
    ms, plain_ms, bound_ms, bound_by = timing[torch.bfloat16]
    record = {"kernels": [{
        "name": "fused_preprocess",
        "route": "cuda",
        "source": "wsinsight_tpu_torch/ops/csrc/fused_preprocess.cu",
        "replaces": "wsinsight_tpu/ops/pallas_preprocess.py:38",
        "launches": launches["fused_preprocess"],
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
