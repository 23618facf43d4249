#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wsinsight_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's two paths at full width and depth with seeded random
weights: patch classification with the zoo model breast-tumor-resnet34.
tcga-brca (350 px patches, resize 224, ResNet34, 2 classes), and the CellViT
cell path with CellViT-SAM-H-x40 (ViT-H, 32 blocks, windowed and global
rel-pos attention; also over a whole slide to its nuclei) and
CellViT-256-x40 (ViT-S/16 with a cls token). Holds
every hand-written kernel against its plain torch version. Phases; any
failure exits non-zero and prints no result line:

  (a) the card's name and power limit; no CUDA -> exit 1;
  (b) build every kernel from the checkout's sources (one nvcc per source),
      printing each kernel's registers and spills as ptxas reports them, and
      beside them the host library (native/*.cpp, one g++): its command,
      seconds, whether libjpeg was found, and the libjpeg and zlib it linked;
  (c) K1 (fused uint8 -> PIL resize -> normalize) vs its plain version on the
      card, f32 and bf16, bit for bit, at B=256 350->224, 175->224, 176->224
      (the DCT half decode's patch), 224->224 (a host-resized patch, one tap)
      and 350->299, B=3 97->64, and on x[1:] of a B=257 350 px batch (its
      first image not 16-byte aligned); K1's time over 50 launches (CUDA
      events) at B=256 350->224, 175->224, 176->224, 224->224 and 350->299 in
      both dtypes, with the bytes per second reached and the share of its
      bound;
  (d) ClassifierEngine in parity (fp32, TF32 off, exact resize) and in
      mixed_precision (bf16, K1): 20 batches of B=256 through put -> dispatch
      with the two-deep window of run_inference; patches/s, peak memory, and
      the kernels' launch counts over that run;
  (e) parity on the card vs the same engine on the CPU (8 patches, 1e-3),
      mixed vs parity (0.01), every row finite and summing to 1;
  (f) K2 (fused window attention with SAM rel-pos on the tensor cores:
      3xTF32 mma.sync in f32, bf16 mma.sync) vs its plain version on the
      card, f32 and bf16, on the real rows, at B=32 at the three shapes the
      cell path gives it (SAM-H windowed with its real 16x16 extent,
      valid=(16, 16), as the model launches it, and in f32 also at every
      row; SAM-H global; ViT-256's 257-token row), and in bf16 at SAM-B's
      1024 px global block (B=1, n=4096); its time beside its bound (real
      rows only), its plain version and scaled_dot_product_attention with
      the rel-pos bias as attn_mask (every row: the call the model would
      make instead);
  (g) CellEngine for CellViT-SAM-H-x40 (init_random, seed 0), parity and
      bf16: 8 batches of B=32 seeded uint8 patches, one batch deep through
      device_postprocess -> scatter into a canvas on a 16x16 patch grid;
      patches/s, peak memory, K2 launches (32 per batch), device ms of the
      forward and of the post-process, K2's share of the forward's device time
      (which must be above 0: the trace found K2 by its kernel's name);
  (h) the same for CellViT-256-x40 (12 K2 launches per batch);
  (i) cell results: parity on the card vs the same engine on the CPU (2
      patches, maps <= 1e-3); bf16 vs parity canvases (max |d| of NP, HV, TP;
      share of pixels whose NP > 0.5 decision or TP argmax differs; NP
      decisions agree on >= 99%); every map finite, TP rows summing to 1;
  (j) slide-level classification through the port's host stack: a seeded
      synthetic slide (24,576 x 24,576 px at 0.25 um/px, JPEG tiles of 256,
      3 levels, H&E-coloured tissue blobs over about half of it, per-pixel
      noise) written with the port's write_pyramidal_tiff, and a lossless
      twin (deflate, one level) of its top-left quarter; plan_slide with
      the CLI's defaults for the model (thumbnail, segmentation, grid; host
      seconds); PatchBatchSource.from_coords alone at B=256, on each slide:
      decode patches/s through the native reader at the CLI's default worker
      count and at one per core, and through the Python tile path (forced)
      at one per core, with the slide's count of native and Python reads
      (the JPEG slide decodes natively only where libjpeg was found);
      classify_slide with ClassifierEngine in parity and bf16 (K1) at B=256:
      patches/s over the slide, peak memory, device-busy share (per-batch
      step times from CUDA events over the wall time), the CSV through the
      port's writer; checks: the CSV holds the plan's coords in order under
      the model's header, rows finite and summing to 1, bf16 vs parity
      <= 0.01, 8 of the slide's patches on the card vs the CPU <= 1e-3, K1
      launches equal to the bf16 run's batches, every patch read natively
      (Python reads 0) where libjpeg was found, else every one in Python;
  (k) the fast input on the same slide and plan: bf16 with the YUV 4:2:0 wire
      and the DCT half decode (WSINSIGHT_WIRE=yuv420 WSINSIGHT_DECODE_SCALE=2;
      the source says whether the half decode ran: it needs a JPEG page and
      libjpeg), bf16 with the host resize on the RGB wire
      (WSINSIGHT_HOST_RESIZE=1), and parity with the host resize: patches/s,
      device-busy share, put ms and bytes per batch, peak memory; checks: K1
      launches equal to the bf16 runs' batches, parity with the host resize
      equal to (j)'s parity run within 1e-6, the packed fast input of 8
      patches on the card vs the CPU (parity) <= 1e-3, rows finite and
      summing to 1, and the Macenko stain estimate of a 256-patch sample on
      the card vs the CPU <= 1e-4; reported, not checked (lossy by contract):
      max |dp| and argmax agreement of each bf16 run against (j)'s bf16 run;
  (l) a whole slide through the cell path: a seeded synthetic slide (8,192 x
      8,192 px at 0.25 um/px, JPEG tiles of 256 at quality 85, 3 levels;
      (j)'s tissue tones and noise with dark-purple nuclei 4-8 um across)
      planned by plan_slide on CellViT-SAM-H-x40's halo grid (256 px, halo
      46, step 164), then for (g)'s SAM-H engines in parity and bf16:
      PatchBatchSource.from_coords (B=32, the CLI's decode pool) ->
      stitch_slide -> finalize (the CLI's --stitch-workers) -> the CSV through
      write_slide_csv: patches/s without and with the finalize, device-busy
      share, the main thread's split (decode wait, put, dispatch, scatter,
      rest), the finalize's seconds, workers and tiles/s, the foreground share
      and instance count, peak device memory and the canvases' host bytes;
      checks: K2 launches 32 per batch and K1 none, the CSV one row per
      instance (finite, rows summing to 1 within K/2 levels), boxes,
      probabilities and polygons aligned and each polygon inside its bbox,
      the native watershed equal to the Python one (and to
      segment_instances) on a 512^2 crop of the parity canvas's first tile,
      and finalize with WSINSIGHT_DEVICE_RIDGE=1 (the energy in torch on the
      card) giving the cv2 path's instance set; reported, not checked: bf16
      against parity instances.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}, printed exactly when every phase passed, and
then the script exits 0; otherwise it exits 1 (also where CUDA is missing or
the port's package is not beside it). Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MODEL = "breast-tumor-resnet34.tcga-brca"
N_BATCHES = 20
BATCH = 256
SEED = 0
CELL_MODELS = (("CellViT-SAM-H-x40", 32), ("CellViT-256-x40", 12))  # (model, K2 launches/batch)
CELL_BATCHES = 8
CELL_BATCH = 32
CELL_GRID = 16  # the cell canvas is a CELL_GRID x CELL_GRID grid of patches
# K1's timed resizes at B=BATCH: the main path's 350 -> 224 first, then
# upsampling 175 -> 224, the fast input's 176 -> 224 (DCT half decode) and
# 224 -> 224 (host resize), and the odd output width of 350 -> 299.
K1_TIMED = ((350, 224), (175, 224), (176, 224), (224, 224), (350, 299))

# Data-sheet rates by card name: (bytes/s, fp32 FLOP/s outside the tensor
# cores, dense bf16 tensor-core FLOP/s, dense TF32 tensor-core FLOP/s).
CARD_RATES = {
    "H100 80GB HBM3": (3.35e12, 67e12, 989e12, 494.7e12),  # H100 SXM
    "H100 PCIe": (2.0e12, 51e12, 756e12, 378e12),
    "H100 NVL": (3.9e12, 60e12, 835e12, 417.5e12),
    "H200": (4.8e12, 67e12, 989e12, 494.7e12),
}
# K2 at the cell path's shapes, B=32 in both dtypes, and SAM-B's global block
# at 1024 px (n=4096, 64 key tiles) at B=1 in bf16: (name, qkv grid HP x WP,
# dim, heads, window, rel-pos, B, dtypes, valid). SAM-H's windowed blocks
# run on its 16x16 grid padded to 28x28.
K2_SHAPES = (
    ("sam_h_windowed", (28, 28), 1280, 16, 14, True, CELL_BATCH, ("float32", "bfloat16"),
     (16, 16)),
    ("sam_h_windowed_all_rows", (28, 28), 1280, 16, 14, True, CELL_BATCH, ("float32",), None),
    ("sam_h_global", (16, 16), 1280, 16, 0, True, CELL_BATCH, ("float32", "bfloat16"), None),
    ("vit_256", (1, 257), 384, 6, 0, False, CELL_BATCH, ("float32", "bfloat16"), None),
    ("sam_b_1024_global", (64, 64), 768, 12, 0, True, 1, ("bfloat16",), None),
)
# f32: the same sums in another order. bf16: JAX's bar for its bf16 kernel
# (tests/test_flash_attn.py, 5e-2): the rel values are rounded to bf16 after
# sums in another order, so a pair can land one bf16 ulp apart (2**-5 at
# |rel| >= 4 with these tables), which moves a score by as much; the output
# is bf16 (one ulp is 2**-7 relative) and K2 rounds P before normalising it.
K2_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (5e-2, 5e-2)}
# (j)'s synthetic slide: a core biopsy's size at 40x (6.1 x 6.1 mm).
SLIDE_PX = 24576
SLIDE_MPP = 0.25
SLIDE_TISSUE = 0.5  # share of the slide the blobs cover, on a coarse grid
SLIDE_BACKGROUND = (236, 236, 236)  # neutral glass: no saturation
# H&E tones: hematoxylin-rich purples, eosin pinks
SLIDE_TONES = ((176, 98, 168), (214, 132, 186), (150, 80, 160), (226, 160, 200))
SLIDE_NOISE = 17  # uniform in [-17, 17]: sigma 10.1 levels
TWIN_SIDE = SLIDE_PX // 2  # the lossless twin: the slide's top-left quarter
# (l)'s synthetic slide: a 2 mm tissue-microarray core or needle-biopsy
# fragment at 40x, with nuclei: dark-purple ellipses 4-8 um across, one per
# 60 x 60 px of tissue, on (j)'s tones and noise.
CELL_SLIDE_PX = 8192
CELL_SLIDE_MODEL = "CellViT-SAM-H-x40"
NUCLEUS_TONE = (96, 52, 132)
NUCLEUS_RADII = (8, 16)  # px at 0.25 um/px
NUCLEUS_AREA = 60 * 60  # tissue px per nucleus
WATERSHED_CROP = 512  # the native vs Python watershed check's crop side


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

    bw, flops_peak = rates[:2]
    nbytes = b * h * w * 3 + b * oh * ow * 3 * out_bytes
    taps_h = int(_band(w, ow)[1].sum())
    taps_v = int(_band(h, oh)[1].sum())
    flops = 2 * b * 3 * (h * taps_h + ow * taps_v) + 2 * b * oh * ow * 3
    t_bytes, t_ops = nbytes / bw * 1e3, flops / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bound(qkv, rh, rw, heads, window, valid, rates):
    """(least ms, what bounds it) for K2 on the real query rows of
    ``valid`` (h x w of the grid): k and v of every token, q of the real
    tokens and the rel-pos tables read once, the real rows of the output
    written once; per real query row and head, 4*n*hd FLOP for QK^T and PV
    plus 2*(ah+aw)*hd for rel-pos, at the dtype's tensor-core peak: bf16,
    or in f32 three TF32 products for each (3xTF32)."""
    import torch

    b, hp, wp, c3 = qkv.shape
    dim, elt = c3 // 3, qkv.element_size()
    hd = dim // heads
    h, w = valid or (hp, wp)
    ah, aw = (window, window) if window else (hp, wp)
    nbytes = (b * hp * wp * 2 * dim + 2 * b * h * w * dim) * elt
    nbytes += sum(t.numel() * t.element_size() for t in (rh, rw) if t is not None)
    flops = b * h * w * heads * (4 * ah * aw * hd + (2 * (ah + aw) * hd if rh is not None else 0))
    t_ops = flops / rates[2] if qkv.dtype == torch.bfloat16 else 3 * flops / rates[3]
    t_bytes, t_ops = nbytes / rates[0] * 1e3, t_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_inputs(shape, dim, heads, window, rel, dtype, dev, b, rng):
    """Seeded qkv and expanded rel-pos tables, as Attention hands them over."""
    import torch

    (hp, wp), hd = shape, dim // heads
    qkv = torch.from_numpy(rng.standard_normal((b, hp, wp, 3 * dim), dtype=np.float32))
    qkv = qkv.to(dev, dtype)
    if not rel:
        return qkv, None, None
    tables = []
    for a in (window or hp, window or wp):
        table = rng.standard_normal((2 * a - 1, hd), dtype=np.float32) * 0.5
        idx = np.add.outer(np.arange(a), -np.arange(a)) + a - 1
        tables.append(torch.from_numpy(table[idx]).to(dev, dtype))
    return qkv, tables[0], tables[1]


def sdpa_call(qkv, rh, rw, heads, window, scale):
    """scaled_dot_product_attention on K2's q/k/v (window-major, head-major)
    with the rel-pos bias materialised as attn_mask: the library yardstick,
    used nowhere in the port. Returns the call, with its inputs prepared."""
    import torch
    import torch.nn.functional as F

    b, hp, wp, c3 = qkv.shape
    dim, hd = c3 // 3, c3 // 3 // heads
    ah, aw = (window, window) if window else (hp, wp)
    gh, gw, n = hp // ah, wp // aw, ah * aw
    x = qkv.reshape(b, gh, ah, gw, aw, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = (t.reshape(b * gh * gw, heads, n, hd).contiguous() for t in x)
    mask = None
    if rh is not None:
        rq = q.float().reshape(-1, heads, ah, aw, hd)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, rh.float())
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, rw.float())
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(-1, heads, n, n)
        mask = mask.to(qkv.dtype).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def write_synthetic_slide(path: str, side: int, rng: np.random.Generator,
                          twin_path: str, twin_side: int) -> tuple[float, float, float]:
    """Write (j)'s slide: tissue ellipses in H&E tones on neutral glass, with
    per-pixel noise, built in strips of rows, as a 3-level JPEG pyramid; and
    its lossless twin, the top-left ``twin_side`` px square as one deflate
    level. Returns (tissue share on a coarse grid, seconds, twin seconds)."""
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    t0 = time.perf_counter()
    blobs, tissue = tissue_blobs(side, rng)
    img = np.empty((side, side, 3), np.uint8)
    xs = np.arange(side, dtype=np.float32)[None, :]
    for y0 in range(0, side, 512):
        ys = np.arange(y0, min(side, y0 + 512), dtype=np.float32)[:, None]
        strip = np.empty((len(ys), side, 3), np.int16)
        strip[:] = SLIDE_BACKGROUND
        for y, x, ry, rx, tone in blobs:
            strip[((ys - y) / ry) ** 2 + ((xs - x) / rx) ** 2 <= 1] = tone
        strip += rng.integers(-SLIDE_NOISE, SLIDE_NOISE + 1, strip.shape, dtype=np.int16)
        img[y0:y0 + len(ys)] = np.clip(strip, 0, 255)
    write_pyramidal_tiff(path, img, tile=(256, 256), compression="jpeg", mpp=SLIDE_MPP,
                         levels=3)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_pyramidal_tiff(twin_path, img[:twin_side, :twin_side], tile=(256, 256),
                         compression="deflate", mpp=SLIDE_MPP, levels=1)
    return tissue, secs, time.perf_counter() - t0


def tissue_blobs(side: int, rng: np.random.Generator) -> tuple[list, float]:
    """Seeded tissue ellipses in H&E tones, added until they cover
    SLIDE_TISSUE of a coarse grid: ([(y, x, ry, rx, tone)], share covered)."""
    coarse = np.linspace(0, side, 256, endpoint=False)
    cy, cx = np.meshgrid(coarse, coarse, indexing="ij")
    covered = np.zeros(cy.shape, bool)
    blobs = []
    while covered.mean() < SLIDE_TISSUE:  # add blobs until half is tissue
        y, x = rng.uniform(0.15, 0.85, 2) * side
        ry, rx = rng.uniform(0.08, 0.2, 2) * side
        blobs.append((y, x, ry, rx, SLIDE_TONES[len(blobs) % len(SLIDE_TONES)]))
        covered |= ((cy - y) / ry) ** 2 + ((cx - x) / rx) ** 2 <= 1
    return blobs, float(covered.mean())


def write_nuclei_slide(path: str, side: int, rng: np.random.Generator) -> tuple[float, tuple, float]:
    """Write (l)'s slide: (j)'s tissue tones on neutral glass, nuclei drawn
    over the tissue, then (j)'s per-pixel noise; a 3-level JPEG pyramid with
    tiles of 256 at quality 85. Returns (tissue share, the nuclei drawn as
    (centres, radii, angles), seconds)."""
    import cv2

    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    t0 = time.perf_counter()
    blobs, tissue = tissue_blobs(side, rng)
    img = np.empty((side, side, 3), np.uint8)
    xs = np.arange(side, dtype=np.float32)[None, :]
    for y0 in range(0, side, 512):
        ys = np.arange(y0, min(side, y0 + 512), dtype=np.float32)[:, None]
        img[y0:y0 + len(ys)] = SLIDE_BACKGROUND
        for y, x, ry, rx, tone in blobs:
            img[y0:y0 + len(ys)][((ys - y) / ry) ** 2 + ((xs - x) / rx) ** 2 <= 1] = tone
    n = side * side // NUCLEUS_AREA
    centres = rng.integers(0, side, (n, 2))
    radii = rng.integers(*NUCLEUS_RADII, (n, 2), endpoint=True)
    angles = rng.uniform(0, 180, n)
    in_tissue = (img[centres[:, 1], centres[:, 0]] != SLIDE_BACKGROUND).any(axis=1)
    for (x, y), (rx, ry), a in zip(centres[in_tissue], radii[in_tissue], angles[in_tissue]):
        cv2.ellipse(img, (int(x), int(y)), (int(rx), int(ry)), float(a), 0, 360, NUCLEUS_TONE, -1)
    for y0 in range(0, side, 512):
        strip = img[y0:y0 + 512].astype(np.int16)
        strip += rng.integers(-SLIDE_NOISE, SLIDE_NOISE + 1, strip.shape, dtype=np.int16)
        img[y0:y0 + 512] = np.clip(strip, 0, 255)
    write_pyramidal_tiff(path, img, tile=(256, 256), compression="jpeg", mpp=SLIDE_MPP,
                         levels=3)
    nuclei = (centres[in_tissue], radii[in_tissue], angles[in_tissue])
    return tissue, nuclei, time.perf_counter() - t0


def paint_nuclei(st, nuclei, rng: np.random.Generator) -> None:
    """Fill a stitcher's canvases with the maps a perfect model would give
    for the drawn nuclei: NP 1 inside a nucleus, HV the offset from its
    centre over its larger radius (the last drawn of two overlapping nuclei
    owns their overlap), TP one seeded class per nucleus, background class 0
    outside."""
    import cv2

    centres, radii, angles = nuclei
    owner = np.zeros(st.np_map.shape, np.int32)
    for i, ((x, y), (rx, ry), a) in enumerate(zip(centres, radii, angles), start=1):
        cv2.ellipse(owner, (int(x), int(y)), (int(rx), int(ry)), float(a), 0, 360, i, -1)
    fg = owner > 0
    ys, xs = np.nonzero(fg)
    idx = owner[ys, xs] - 1
    r = radii.max(axis=1).astype(np.float32)
    st.np_map[:] = fg
    st.hv_map[:] = 0
    st.hv_map[ys, xs, 0] = (xs - centres[idx, 0]) / r[idx]
    st.hv_map[ys, xs, 1] = (ys - centres[idx, 1]) / r[idx]
    st.tp_map[:] = 0
    st.tp_map[..., 0] = ~fg
    st.tp_map[ys, xs, rng.integers(1, st.n_classes, len(centres))[idx]] = 1


class Window:
    """Where classify_slide's window goes: the main thread's host seconds
    waiting for decoded batches, in ``put`` (pin + enqueue of the copy) and
    in ``dispatch`` (enqueue of the step), and the device time of each step
    (CUDA events around it). Wraps the engine's put and dispatch."""

    def __init__(self, engine):
        import torch

        self.host = {"decode_wait": 0.0, "put": 0.0, "dispatch": 0.0}
        self.steps = []
        put, dispatch = engine.put, engine.dispatch

        def timed_put(images):
            t0 = time.perf_counter()
            out = put(images)
            self.host["put"] += time.perf_counter() - t0
            return out

        def timed_dispatch(images):
            t0 = time.perf_counter()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = dispatch(images)
            end.record()
            self.steps.append((start, end))
            self.host["dispatch"] += time.perf_counter() - t0
            return out

        engine.put, engine.dispatch = timed_put, timed_dispatch

    def batches(self, src):
        """Iterate ``src``, adding the time spent waiting for each batch."""
        it = iter(src)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.host["decode_wait"] += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def device_s(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.steps) / 1e3


def run_cells(engine, stitcher, data, coords):
    """The cell path's device half, one batch deep, as run_cell_inference
    drives it. Returns the seconds on the host clock."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = None
    for images, xy in zip(data, coords):
        pred = engine.dispatch(engine.put(images))
        maps = stitcher.device_postprocess(pred)
        if pending is not None:
            stitcher.scatter(*pending)
        pending = (maps, xy, len(images))
    stitcher.scatter(*pending)
    return time.perf_counter() - t0


def k2_share(engine, x) -> float:
    """K2's share of the device time of one forward, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.dispatch(x)
            torch.cuda.synchronize()
        total = k2 = 0.0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
            total += t
            k2 += t if "window_attention_kernel" in evt.key else 0.0
        return k2 / total if total else float("nan")
    except Exception as err:  # the trace is a report, not a check
        print(f"    profiler trace failed: {err!r}")
        return float("nan")


def decode_alone(path, coords, ps, threads, python=False):
    """Decode a plan's patches alone through PatchBatchSource at B=BATCH:
    (patches/s, the slide's reads). ``python`` forces every level onto the
    Python tile path, as tests/test_native_decode.py forces it."""
    from wsinsight_tpu_torch.engine.data import PatchBatchSource

    t0 = time.perf_counter()
    src = PatchBatchSource.from_coords(path, coords, ps, BATCH, num_threads=threads)
    if python:
        src._slide._native = {lvl: False for lvl in range(src._slide.level_count)}
    try:
        got = sum(b.n_valid for b in src)
    finally:
        src.close()
    return got / (time.perf_counter() - t0), dict(src._slide.reads)


def run_slide(engine, kernels, path, coords, ps, workers, **source_opts):
    """classify_slide over a plan, timed: (coords, probs, stats). Stats hold
    patches/s, device-busy share, the main thread's split, put ms and bytes
    per batch, peak memory, kernel launches, the slide's reads and what the
    source shipped (wire, decode scale, image size)."""
    import torch

    from wsinsight_tpu_torch.engine.data import PatchBatchSource
    from wsinsight_tpu_torch.engine.runner import classify_slide

    plain = engine.put, engine.dispatch
    window = Window(engine)
    sizes = []
    put = engine.put

    def put_sized(images):
        sizes.append(images.nbytes)
        return put(images)

    engine.put = put_sized
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    src = PatchBatchSource.from_coords(path, coords, ps, BATCH, num_threads=workers,
                                       **source_opts)
    try:
        out_coords, probs = classify_slide(engine, src, window.batches(src))
    finally:
        src.close()
        engine.put, engine.dispatch = plain
    wall = time.perf_counter() - t0
    n = len(coords)
    stats = {"patches_s": n / wall, "wall_s": wall, "busy": window.device_s() / wall,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "host_shares": {k: v / wall for k, v in window.host.items()},
             "put_ms_per_batch": window.host["put"] / len(sizes) * 1e3,
             "bytes_per_batch": sizes[0], "launches": {name: fn.launches for fn, name in kernels.items()},
             "reads": dict(src._slide.reads), "wire": src.wire or "rgb",
             "decode_scale": src.decode_scale, "image_hw": list(src.image_hw)}
    return out_coords, probs, stats


def slide_phase(check, kernels, card, rng, side: int = SLIDE_PX) -> dict:
    """(j): one synthetic slide through plan_slide -> PatchBatchSource ->
    classify_slide -> the CSV writer, in parity and bf16; then (k), the fast
    input on the same slide."""
    import pandas as pd
    import psutil  # the decode pool's governor counts physical cores
    import torch

    from wsinsight_tpu_torch import native
    from wsinsight_tpu_torch.cli.infer import default_infer_workers
    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.engine.data import PatchBatchSource
    from wsinsight_tpu_torch.engine.runner import write_slide_csv
    from wsinsight_tpu_torch.ops.preprocess import TransformSpec
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils.workers import governed_workers
    from wsinsight_tpu_torch.zoo import ModelHandle, get_registered_model, make_random_local_model

    tmp = tempfile.TemporaryDirectory()
    path, twin = f"{tmp.name}/slide.tif", f"{tmp.name}/twin.tif"
    tissue, secs, twin_secs = write_synthetic_slide(path, side, rng, twin, TWIN_SIDE)
    size = os.path.getsize(path)
    print(f"(j) slide {side} x {side} px at {SLIDE_MPP} um/px, JPEG tiles of 256, 3 levels,"
          f" tissue {tissue:.1%} of a coarse grid: {size / 2**20:.1f} MiB written in {secs:.1f} s"
          f"; its lossless twin ({TWIN_SIDE} px square, deflate tiles of 256, one level):"
          f" {os.path.getsize(twin) / 2**20:.1f} MiB in {twin_secs:.1f} s (kept out of every"
          f" rate); {card}")

    handle = get_registered_model(MODEL)
    cfg = handle.config
    t0 = time.perf_counter()
    plan, ctx, *_ = plan_slide(URIPath(path), None, None, None, cfg.patch_size_pixels,
                               cfg.spacing_um_px)  # the CLI's defaults
    plan_s = time.perf_counter() - t0
    ctx.slide.close()
    n, ps = len(plan.coords), plan.patch_size
    n_batches = -(-n // BATCH)
    twin_coords = plan.coords[(plan.coords < TWIN_SIDE - ps).all(axis=1)]
    print(f"    plan_slide (thumbnail, segmentation, grid): {plan_s:.2f} s on the host;"
          f" {n} patches of {ps} px, {n_batches} batches of B={BATCH}; {len(twin_coords)}"
          " of them lie inside the twin")

    workers = governed_workers(default_infer_workers())  # as run_inference sizes the pool
    cores = os.cpu_count() or 1
    jpeg = native.has_jpeg()
    print(f"    decode pool: {workers} thread(s) at the CLI's default (min(cpu, 2 x cards) ="
          f" {default_infer_workers()}, then governed_workers; {cores} logical,"
          f" {psutil.cpu_count(logical=False)} physical cores; the host's CPUs"
          f" {psutil.cpu_percent(interval=0.3):.0f}% busy over the next 0.3 s)")
    print(f"    host library built {'with' if jpeg else 'WITHOUT'} libjpeg: the JPEG slide's"
          f" patches decode {'natively' if jpeg else 'through the Python tile path (cv2)'}"
          "; the twin's natively")
    stats = {"patches": n, "batches": n_batches, "plan_s": plan_s, "write_s": secs,
             "twin_patches": len(twin_coords), "twin_write_s": twin_secs, "tissue": tissue,
             "card": card, "libjpeg": jpeg, "decode": {}}
    for name, p, coords in (("jpeg", path, plan.coords), ("twin", twin, twin_coords)):
        native_runs = [("native", t, False) for t in sorted({workers, cores})] if (
            name == "twin" or jpeg) else []
        for how, threads, python in native_runs + [("python", cores, True)]:
            rate, reads = decode_alone(p, coords, ps, threads, python)
            stats["decode"][f"{name}_{how}_{threads}_threads"] = {"patches_s": rate,
                                                                  "reads": reads}
            print(f"    decode alone, {name} slide, {how} path, {threads} thread(s)"
                  f"{' (the CLI default)' if threads == workers else ''}: {rate:.1f} patches/s"
                  f" ({len(coords)} patches; reads {reads}); {card}")
            want = {"native": 0, "python": len(coords)} if python else {"native": len(coords),
                                                                         "python": 0}
            check(reads == want, f"{name} slide, {how} decode at {threads} thread(s): reads"
                  f" {reads} ({want})")

    tmp_model = tempfile.TemporaryDirectory()
    _, weights = make_random_local_model("resnet34", 2, tmp_model.name, seed=SEED)
    handle = ModelHandle(name=MODEL, config=cfg, weights_path=str(weights))
    warm = rng.integers(0, 256, (BATCH, ps, ps, 3), dtype=np.uint8)
    header = ",".join(["minx", "miny", "width", "height"] + [f"prob_{c}" for c in cfg.class_names])
    want = np.concatenate([plan.coords, np.full_like(plan.coords, ps)], axis=1)
    probs, counts, engines = {}, {}, {}
    for mixed in (False, True):
        mode = "bf16" if mixed else "parity"
        engine = engines[mode] = ClassifierEngine(handle, mixed_precision=mixed)
        engine.run_batch(warm, BATCH)  # warm-up: cuDNN plans, pinned buffers
        coords, probs[mode], st = run_slide(engine, kernels, path, plan.coords, ps, workers)
        counts[mode] = st["launches"]
        stats[mode] = st
        csv = URIPath(f"{tmp.name}/{mode}.csv")
        write_slide_csv(csv, coords, probs[mode], cfg.class_names)
        with open(str(csv)) as fh:
            first = fh.readline().strip()
        df = pd.read_csv(str(csv))
        host = st["host_shares"]
        print(f"    {mode} end to end: {st['patches_s']:.1f} patches/s over the slide"
              f" ({st['wall_s']:.2f} s), device busy {st['busy']:.1%} of the wall time, peak"
              f" {st['peak_gib']:.2f} GiB, put {st['put_ms_per_batch']:.2f} ms and"
              f" {st['bytes_per_batch'] / 1e6:.1f} MB per batch; reads {st['reads']}; {card}")
        print(f"    {mode} main thread, share of the wall time: waiting for decoded batches"
              f" {host['decode_wait']:.1%}, put {host['put']:.1%}, dispatch"
              f" {host['dispatch']:.1%}, the rest (fetching probabilities, CSV rows)"
              f" {1 - sum(host.values()):.1%}")
        print(f"    {mode} CSV {csv}: {len(df)} rows, header {first}")
        check(first == header and len(df) == n
              and np.array_equal(df[["minx", "miny", "width", "height"]].to_numpy(), want),
              f"{mode}: the CSV holds the plan's {n} coords in order under {header}")
        p = df[[f"prob_{c}" for c in cfg.class_names]].to_numpy()
        dsum = float(np.abs(p.sum(axis=1) - 1.0).max())
        check(bool(np.isfinite(p).all()) and dsum <= 1e-5,
              f"{mode}: every row finite, sums to 1 within {dsum:.3g} (<= 1e-5)")
        check(counts[mode]["window_attention"] == 0, f"{mode}: K2 launches 0")
        want_reads = {"native": n, "python": 0} if jpeg else {"native": 0, "python": n}
        check(st["reads"] == want_reads,
              f"{mode}: reads over the slide {st['reads']} ({want_reads}:"
              f" {'every patch native' if jpeg else 'no libjpeg, every JPEG patch in Python'})")
    err = float(np.abs(probs["bf16"] - probs["parity"]).max())
    check(err <= 0.01, f"bf16 vs parity over the slide's {n} patches: max |dp| {err:.3g} (<= 0.01)")
    check(counts["bf16"]["fused_preprocess"] == n_batches,
          f"K1 launches over the bf16 slide run: {counts['bf16']['fused_preprocess']}"
          f" (batches: {n_batches})")
    check(counts["parity"]["fused_preprocess"] == 0, "K1 launches over the parity slide run: 0")
    src = PatchBatchSource.from_coords(path, plan.coords[:8], ps, 8, num_threads=workers)
    batch = next(iter(src))
    src.close()
    cpu = ClassifierEngine(handle, device="cpu")
    err = float(np.abs(probs["parity"][:8] - cpu.run_batch(batch.images, 8)).max())
    check(err <= 1e-3, f"parity on the card vs the CPU, the slide's first 8 patches through the"
          f" same source: max |dp| {err:.3g} (<= 1e-3)")
    print(f"    {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")
    k1_launches = counts["bf16"]["fused_preprocess"]

    # (k) ------------------------------------------------------------------
    from wsinsight_tpu_torch.ops.stain import estimate_stains_from_batch

    t_k = time.perf_counter()
    print(f"(k) the fast input on the same slide and plan ({n} patches, {workers} decode"
          f" thread(s)); {card}")
    resized = TransformSpec.from_config(cfg.transform).size  # as run_inference passes it
    runs = (("bf16", "yuv420 wire + DCT half decode", dict(wire="yuv420", decode_scale=2)),
            ("bf16", "host resize, RGB wire", dict(host_resize=resized)),
            ("parity", "host resize, RGB wire", dict(host_resize=resized)))
    fast = {}
    for mode, what, opts in runs:
        engine = engines[mode]
        _, p, st = run_slide(engine, kernels, path, plan.coords, ps, workers, **opts)
        fast[f"{mode} {what}"] = st
        print(f"    {mode}, {what}: shipped {st['wire']} at {st['image_hw'][0]} px (decode scale"
              f" 1/{st['decode_scale']}): {st['patches_s']:.1f} patches/s, device busy"
              f" {st['busy']:.1%}, put {st['put_ms_per_batch']:.2f} ms and"
              f" {st['bytes_per_batch'] / 1e6:.2f} MB per batch, peak {st['peak_gib']:.2f} GiB;"
              f" reads {st['reads']}; {card}")
        dsum = float(np.abs(p.sum(axis=1) - 1.0).max())
        check(p.shape == (n, 2) and bool(np.isfinite(p).all()) and dsum <= 1e-5,
              f"(k) {mode}, {what}: rows finite, sum to 1 within {dsum:.3g}")
        if mode == "bf16":
            k1_launches += st["launches"]["fused_preprocess"]
            check(st["launches"]["fused_preprocess"] == n_batches,
                  f"(k) {mode}, {what}: K1 launches {st['launches']['fused_preprocess']}"
                  f" (batches: {n_batches})")
            d = np.abs(p - probs["bf16"])
            agree = float((p.argmax(1) == probs["bf16"].argmax(1)).mean())
            st["vs_exact_bf16"] = {"max_abs_dp": float(d.max()), "argmax_agree": agree}
            print(f"        against (j)'s bf16 run on the exact RGB wire (lossy by contract, not"
                  f" checked): max |dp| {float(d.max()):.3g}, argmax agrees on {agree:.2%}")
        else:
            err = float(np.abs(p - probs["parity"]).max())
            check(err <= 1e-6, f"(k) parity with the host resize vs (j)'s parity run (device"
                  f" resize): max |dp| {err:.3g} (<= 1e-6)")
    src = PatchBatchSource.from_coords(path, plan.coords[:8], ps, 8, num_threads=workers,
                                       wire="yuv420", decode_scale=2)
    packed = next(iter(src)).images
    src.close()
    err = float(np.abs(engines["parity"].run_batch(packed, 8) - cpu.run_batch(packed, 8)).max())
    check(packed.ndim == 3 and err <= 1e-3, f"(k) the packed fast input {packed.shape}, parity on"
          f" the card vs the CPU: max |dp| {err:.3g} (<= 1e-3)")
    src = PatchBatchSource.from_coords(path, plan.coords, ps, BATCH, num_threads=cores,
                                       shuffle_seed=0)
    sample = next(iter(src))
    src.close()
    w_card = estimate_stains_from_batch(sample.images[: sample.n_valid], device="cuda")
    w_cpu = estimate_stains_from_batch(sample.images[: sample.n_valid], device="cpu")
    err = float(np.abs(w_card - w_cpu).max())
    check(bool(np.isfinite(w_card).all()) and err <= 1e-4, f"(k) Macenko stain estimate of a"
          f" {sample.n_valid}-patch sample, card vs CPU: max |d| {err:.3g} (<= 1e-4)")
    stats["fast_input"] = fast
    print(f"    (k) took {time.perf_counter() - t_k:.1f} s;"
          f" {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")
    del engines, cpu
    torch.cuda.empty_cache()
    tmp.cleanup()
    tmp_model.cleanup()
    return {"stats": stats, "k1_launches": k1_launches}


def run_cell_slide(engine, kernels, path, coords, ps, dims, workers, stitch_workers):
    """The cell path over a plan: PatchBatchSource.from_coords -> stitch_slide
    -> finalize, timed. Returns (stitcher, (boxes, probs, polygons), stats):
    patches/s without and with the finalize, device-busy share, the main
    thread's split, the finalize's seconds and tiles, peak memory, the
    canvases' bytes and kernel launches."""
    import torch

    from wsinsight_tpu_torch.engine.cells import make_slide_stitcher, stitch_slide
    from wsinsight_tpu_torch.engine.data import PatchBatchSource

    cfg = engine.config
    plain = engine.put, engine.dispatch
    window = Window(engine)
    window.host["scatter"] = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    stitcher = make_slide_stitcher(engine, dims[0], dims[1], SLIDE_MPP, cfg.halo_size_pixels)
    scatter = stitcher.scatter

    def timed_scatter(*args):
        t = time.perf_counter()
        scatter(*args)
        window.host["scatter"] += time.perf_counter() - t

    stitcher.scatter = timed_scatter
    src = PatchBatchSource.from_coords(path, coords, ps, CELL_BATCH, num_threads=workers,
                                       decode_scale=1)
    try:
        stitch_slide(engine, stitcher, src, window.batches(src))
    finally:
        src.close()
        engine.put, engine.dispatch = plain
        stitcher.scatter = scatter
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for fn, name in kernels.items()}
    t1 = time.perf_counter()
    out = stitcher.finalize(num_workers=stitch_workers)
    fin = time.perf_counter() - t1
    h, w = stitcher.slide_height, stitcher.slide_width
    tiles = -(-h // 2048) * -(-w // 2048)
    n = len(coords)
    stats = {"patches": n, "batches": src.num_batches, "patches_s": n / wall,
             "patches_s_with_finalize": n / (wall + fin), "wall_s": wall, "finalize_s": fin,
             "finalize_workers": stitch_workers, "tiles": tiles, "tiles_s": tiles / fin,
             "busy": window.device_s() / wall,
             "host_shares": {k: v / wall for k, v in window.host.items()},
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "canvas_bytes": stitcher.np_map.nbytes + stitcher.hv_map.nbytes
             + stitcher.tp_map.nbytes,
             "foreground": float((stitcher.np_map >= 0.5).mean()), "instances": len(out[0]),
             "launches": launches, "reads": dict(src._slide.reads)}
    return stitcher, out, stats


def same_instances(a, b) -> tuple[bool, float]:
    """(whether two finalize results hold the same instance set: boxes and
    polygons identical after sorting by (miny, minx, h, w); max |dp| of the
    class probabilities)."""
    if len(a[0]) != len(b[0]):
        return False, float("nan")
    if not a[0]:
        return True, 0.0

    def ordered(out):
        boxes = np.concatenate(out[0])
        order = np.lexsort((boxes[:, 3], boxes[:, 2], boxes[:, 0], boxes[:, 1]))
        return boxes[order], np.concatenate(out[1])[order], [out[2][i] for i in order]

    (ba, pa, ra), (bb, pb, rb) = ordered(a), ordered(b)
    same = np.array_equal(ba, bb) and all(np.array_equal(x, y) for x, y in zip(ra, rb))
    return same, float(np.abs(pa - pb).max())


def watershed_crop_check(check, st, what: str) -> dict:
    """The native watershed against the Python one (and segment_instances)
    on the 512^2 crop of a canvas's first full tile with the most foreground,
    seeds, basin and mask as segment_instances builds them."""
    from wsinsight_tpu_torch.ops import hv_postproc as hv
    from wsinsight_tpu_torch.ops.watershed import _watershed_python, watershed

    tile = st.np_map[:2048 + 64, :2048 + 64]
    c = WATERSHED_CROP
    fg_sums = {(y, x): float((tile[y:y + c, x:x + c] >= 0.5).sum())
               for y in range(0, tile.shape[0] - c + 1, c // 2)
               for x in range(0, tile.shape[1] - c + 1, c // 2)}
    y0, x0 = max(fg_sums, key=fg_sums.get)
    np_c = np.ascontiguousarray(st.np_map[y0:y0 + c, x0:x0 + c])
    hv_c = np.ascontiguousarray(st.hv_map[y0:y0 + c, x0:x0 + c])
    fg_raw = np_c >= hv._FG_THRESHOLD
    fg = hv._label_small_filtered(fg_raw.astype(np.uint8), st.min_object_size) > 0
    e_u8 = hv._energy_u8(hv_c, fg_raw, None)
    basin = hv._integer_basin(e_u8, fg_raw)
    markers = hv._seeds(fg, e_u8 >= hv._BOUNDARY_U8, st.min_object_size)
    t0 = time.perf_counter()
    native = watershed(basin, markers, fg)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = _watershed_python(basin, markers, fg.astype(np.uint8))
    python_s = time.perf_counter() - t0
    seg = hv.segment_instances(np_c, hv_c, st.min_object_size)
    seeds, labels = len(np.unique(markers)) - 1, len(np.unique(native)) - 1
    check(np.array_equal(native, python) and np.array_equal(native, seg),
          f"(l) native watershed = Python watershed = segment_instances, label for label, on the"
          f" {c}^2 crop at ({x0}, {y0}) of {what}'s first tile: {int(fg.sum())} mask px, {seeds}"
          f" seeds, {labels} labels; native {native_s * 1e3:.1f} ms, Python {python_s:.2f} s")
    return {"at": [int(x0), int(y0)], "mask_px": int(fg.sum()), "seeds": seeds,
            "labels": labels, "native_s": native_s, "python_s": python_s}


def ridge_check(check, st, workers: int, cv2_path, what: str) -> dict:
    """finalize with WSINSIGHT_DEVICE_RIDGE=1 (the energy in torch on the
    stitcher's device, the card) against the cv2 path's result on the same
    canvases: the same instance set."""
    import wsinsight_tpu_torch.ops.hv_device as hv_device

    calls = []
    energy = hv_device.separation_energy_batched

    def counted(hv_tiles, device):
        calls.append((hv_tiles.shape, str(device)))
        return energy(hv_tiles, device)

    hv_device.separation_energy_batched = counted
    os.environ["WSINSIGHT_DEVICE_RIDGE"] = "1"
    try:
        t0 = time.perf_counter()
        ridge = st.finalize(num_workers=workers)
        ridge_s = time.perf_counter() - t0
    finally:
        del os.environ["WSINSIGHT_DEVICE_RIDGE"]
        hv_device.separation_energy_batched = energy
    same, dp = same_instances(ridge, cv2_path)
    on_card = bool(calls) and all(d.startswith("cuda") for _, d in calls)
    check(on_card and same, f"(l) {what}: finalize with WSINSIGHT_DEVICE_RIDGE=1 ({len(calls)}"
          f" energy batch(es) of {calls[0][0] if calls else None} on"
          f" {calls[0][1] if calls else None}, {ridge_s:.2f} s) gives the cv2 path's instance set"
          f" ({len(ridge[0])} instances, boxes and polygons identical), max |dp| {dp:.3g}")
    return {"finalize_s": ridge_s, "energy_batches": len(calls), "same": same, "max_abs_dp": dp}


def cell_slide_phase(check, kernels, card, rng, engines) -> dict:
    """(l): a synthetic slide with nuclei through the cell path: plan_slide
    (halo grid) -> PatchBatchSource -> stitch_slide -> finalize -> the CSV,
    with CellViT-SAM-H-x40 in parity and bf16; the native watershed against
    the Python one and the ridge on the card against the cv2 path, on the
    parity canvases and on the drawn nuclei's own maps."""
    import pandas as pd

    from wsinsight_tpu_torch.cli.infer import default_infer_workers, default_stitch_workers
    from wsinsight_tpu_torch.engine.runner import write_slide_csv
    from wsinsight_tpu_torch.ops.watershed import _watershed_python, watershed
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils.workers import governed_workers

    tmp = tempfile.TemporaryDirectory()
    path = f"{tmp.name}/cells.tif"
    side = CELL_SLIDE_PX
    tissue, nuclei, secs = write_nuclei_slide(path, side, rng)
    print(f"(l) slide {side} x {side} px at {SLIDE_MPP} um/px ({side * SLIDE_MPP / 1000:.2f} mm"
          f" square), JPEG tiles of 256 at quality 85, 3 levels, tissue {tissue:.1%} of a coarse"
          f" grid, {len(nuclei[0])} nuclei drawn: {os.path.getsize(path) / 2**20:.1f} MiB written in"
          f" {secs:.1f} s (kept out of every rate); {card}")
    cfg = engines[False].config
    t0 = time.perf_counter()
    plan, ctx, *_ = plan_slide(URIPath(path), None, None, None, cfg.patch_size_pixels,
                               cfg.spacing_um_px, cfg.halo_size_pixels, object_based=True,
                               object_detection="end2end")  # the CLI's defaults
    plan_s = time.perf_counter() - t0
    dims = ctx.slide.dimensions
    ctx.slide.close()
    n, ps = len(plan.coords), plan.patch_size
    step = int(np.diff(np.unique(plan.coords[:, 0])).min())
    workers = governed_workers(default_infer_workers())  # as run_cell_inference sizes the pool
    stitch_workers = default_stitch_workers()  # the CLI's --stitch-workers
    n_batches = -(-n // CELL_BATCH)
    print(f"    plan_slide, halo grid of {CELL_SLIDE_MODEL} ({ps} px, halo"
          f" {cfg.halo_size_pixels}, step {step}): {n} patches, {n_batches} batches of"
          f" B={CELL_BATCH}, in {plan_s:.2f} s on the host; decode pool {workers} thread(s),"
          f" finalize {stitch_workers} worker(s) (the CLI's defaults)")
    check(step == ps - 2 * cfg.halo_size_pixels, f"(l) the halo grid's step {step} (patch - 2 x"
          f" halo = {ps - 2 * cfg.halo_size_pixels})")
    header = ",".join(["minx", "miny", "width", "height"] + [f"prob_{c}" for c in cfg.class_names])
    stats = {"side": side, "tissue": tissue, "nuclei_drawn": len(nuclei[0]), "write_s": secs,
             "plan_s": plan_s, "patches": n, "card": card}
    results, stitchers = {}, {}
    k2_launches = 0
    for mixed in (False, True):
        mode = "bf16" if mixed else "parity"
        engine = engines[mixed]
        st, out, run = run_cell_slide(engine, kernels, path, plan.coords, ps, dims, workers,
                                      stitch_workers)
        stats[mode] = run
        results[mode] = out
        host = run["host_shares"]
        print(f"    {mode}: {run['patches_s']:.1f} patches/s over the slide without the finalize"
              f" ({run['wall_s']:.2f} s), {run['patches_s_with_finalize']:.1f} with it; device"
              f" busy {run['busy']:.1%} of the wall time; peak {run['peak_gib']:.2f} GiB on the"
              f" card, canvases {run['canvas_bytes'] / 1e9:.2f} GB on the host; reads"
              f" {run['reads']}; {card}")
        print(f"    {mode} main thread, share of the wall time: waiting for decoded batches"
              f" {host['decode_wait']:.1%}, put {host['put']:.1%}, dispatch"
              f" {host['dispatch']:.1%}, scatter {host['scatter']:.1%}, the rest"
              f" {1 - sum(host.values()):.1%}")
        print(f"    {mode} finalize: {run['finalize_s']:.2f} s on {run['finalize_workers']}"
              f" worker(s), {run['tiles']} tiles, {run['tiles_s']:.2f} tiles/s"
              f" ({run['finalize_s'] / (run['wall_s'] + run['finalize_s']):.1%} of the slide's"
              f" time); foreground (NP >= 0.5) {run['foreground']:.2%} of the canvas,"
              f" {run['instances']} instances")
        k2 = run["launches"]["window_attention"]
        k2_launches += k2
        check(k2 == 32 * run["batches"] and run["batches"] == n_batches,
              f"(l) {mode}: K2 launches {k2} (32 per batch x {run['batches']} batches)")
        check(run["launches"]["fused_preprocess"] == 0, f"(l) {mode}: K1 launches 0")
        boxes, probs, polys = out
        check(len(boxes) == len(probs) == len(polys), f"(l) {mode}: boxes, probabilities and"
              f" polygons aligned ({len(boxes)}, {len(probs)}, {len(polys)})")
        inside = all(len(r) >= 3 and (r.min(0) >= b[0, :2]).all()
                     and (r.max(0) <= b[0, :2] + b[0, 2:] - 1).all() for b, r in zip(boxes, polys))
        check(inside, f"(l) {mode}: every polygon (>= 3 vertices) lies inside its bbox")
        csv = URIPath(f"{tmp.name}/{mode}.csv")
        k = cfg.num_classes
        coords_arr = np.concatenate(boxes) if boxes else np.zeros((0, 4), np.int32)
        probs_arr = np.concatenate(probs) if probs else np.zeros((0, k), np.float32)
        write_slide_csv(csv, coords_arr, probs_arr, cfg.class_names)
        with open(str(csv)) as fh:
            first = fh.readline().strip()
        df = pd.read_csv(str(csv))
        p = df[[f"prob_{c}" for c in cfg.class_names]].to_numpy(dtype=np.float64)
        dsum = float(np.abs(p.sum(axis=1) - 1.0).max()) if len(p) else 0.0
        check(first == header and len(df) == len(boxes) and bool(np.isfinite(p).all())
              and dsum <= k * 0.5 / 255 + 1e-6,
              f"(l) {mode}: the CSV has one row per instance ({len(df)}) under {header}, rows"
              f" finite, summing to 1 within {dsum:.3g} (<= K x 1/2 level, quantized transfer)")
        stitchers[mode] = st
        print(f"    {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")
    stitchers["bf16"].close()

    # native vs Python watershed: this machine's build of the host library on
    # seeded random basins with disc seeds, then on crops of the canvases
    fuzz = np.random.default_rng(7)
    img = fuzz.random((WATERSHED_CROP, WATERSHED_CROP)).astype(np.float32)
    mask = fuzz.random(img.shape) < 0.6
    markers = np.zeros(img.shape, np.int32)
    yy, xx = np.mgrid[:WATERSHED_CROP, :WATERSHED_CROP]
    for lab, (cy, cx) in enumerate(fuzz.integers(0, WATERSHED_CROP, (40, 2)), start=1):
        markers[np.hypot(yy - cy, xx - cx) < 6] = lab
    markers[~mask] = 0
    check(np.array_equal(watershed(img, markers, mask),
                         _watershed_python(img, markers, mask.astype(np.uint8))),
          f"(l) native watershed = Python watershed on a seeded random {WATERSHED_CROP}^2 basin"
          " (40 disc seeds, 60% mask)")
    st = stitchers["parity"]
    stats["watershed_crop"] = watershed_crop_check(check, st, "the parity canvas")
    stats["ridge"] = ridge_check(check, st, stitch_workers, results["parity"], "parity canvases")

    # The seeded model leaves few seeds (random HV fields), so its canvases
    # exercise little of the watershed: the same finalize, checks and
    # timing on the maps a perfect model would give for the drawn nuclei.
    paint_nuclei(st, nuclei, rng)
    t0 = time.perf_counter()
    drawn = st.finalize(num_workers=stitch_workers)
    drawn_s = time.perf_counter() - t0
    n_drawn = len(nuclei[0])
    print(f"    the drawn nuclei's own maps ({n_drawn} nuclei, foreground"
          f" {float(st.np_map.mean()):.2%}): finalize {drawn_s:.2f} s on {stitch_workers}"
          f" worker(s), {16 / drawn_s:.2f} tiles/s, {len(drawn[0])} instances"
          f" ({len(drawn[0]) / drawn_s:.0f} per s)")
    boxes, probs, polys = drawn
    inside = all(len(r) >= 3 and (r.min(0) >= b[0, :2]).all()
                 and (r.max(0) <= b[0, :2] + b[0, 2:] - 1).all() for b, r in zip(boxes, polys))
    check(len(boxes) == len(probs) == len(polys) and inside and len(boxes) >= n_drawn // 2,
          f"(l) the drawn-nuclei canvas: {len(boxes)} instances of {n_drawn} drawn nuclei"
          " (>= half: overlapping ones may merge), lists aligned, every polygon inside its bbox")
    stats["drawn"] = {"nuclei": n_drawn, "finalize_s": drawn_s, "instances": len(boxes),
                      "watershed_crop": watershed_crop_check(check, st, "the drawn-nuclei canvas"),
                      "ridge": ridge_check(check, st, stitch_workers, drawn,
                                           "the drawn-nuclei canvas")}
    st.close()

    # reported, not checked: bf16 against parity
    pb = {tuple(b[0]) for b in results["bf16"][0]}
    shared = sum(tuple(b[0]) in pb for b in results["parity"][0])
    share = shared / max(1, len(results["parity"][0]))
    print(f"    bf16 vs parity (not checked): {len(results['bf16'][0])} against"
          f" {len(results['parity'][0])} instances; {share:.1%} of the parity instances' bboxes"
          " occur in bf16")
    stats["bf16_vs_parity"] = {"bbox_share": share}
    tmp.cleanup()
    return {"stats": stats, "k2_launches": k2_launches}


def main() -> int:
    import torch

    # (a) ------------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        import wsinsight_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port's package is not importable ({err}); run the script from"
              " the root of a checkout of the repository", file=sys.stderr)
        return 1
    from wsinsight_tpu_torch import native
    from wsinsight_tpu_torch.engine import CellEngine, ClassifierEngine, TileRemapStitcher
    from wsinsight_tpu_torch.ops.flash_attn import window_attention, window_attention_reference
    from wsinsight_tpu_torch.ops import cuda_build, native_build
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
          f" data-sheet rates {rates[0] / 1e12:.2f} TB/s, fp32 {rates[1] / 1e12:.0f} TFLOP/s,"
          f" bf16 {rates[2] / 1e12:.0f} TFLOP/s, tf32 {rates[3] / 1e12:.1f} TFLOP/s")
    check = Checks()
    dev = torch.device("cuda", 0)
    kernels = {fused_preprocess: "fused_preprocess", window_attention: "window_attention"}

    # (b) ------------------------------------------------------------------
    def build_host():  # runs beside nvcc
        start = time.perf_counter()
        jpeg = native_build.jpeg_available()
        log = native_build.build()
        return jpeg, log, time.perf_counter() - start

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build_host)
        logs = cuda_build.build()
        kernel_s = time.perf_counter() - t0
        jpeg, host_log, host_s = host.result()
    print(f"(b) built {len(logs)} kernel source(s) in {kernel_s:.2f} s")
    for name, log in logs.items():
        for line in cuda_build.ptxas_summary(log):
            print(f"    {name}: {line}")
    lib_path = native_build.library_path()
    print(f"    host library: {' '.join(native_build.command(lib_path))}: {host_s:.2f} s"
          f" (probe and build, beside nvcc); libjpeg {'found' if jpeg else 'NOT found'}")
    for line in host_log.strip().splitlines():
        print(f"    g++: {line}")
    ldd = subprocess.run(["ldd", str(lib_path)], capture_output=True, text=True, timeout=60)
    linked = [ln.strip() for ln in ldd.stdout.splitlines() if "jpeg" in ln or "libz." in ln]
    print(f"    linked: {'; '.join(linked) or ldd.stdout.strip()}")
    check(native.has_jpeg() == jpeg, f"host library loads; its JPEG codec is"
          f" {'in' if jpeg else 'left out (-DWSI_NO_JPEG)'}")
    if not jpeg:
        print("    no libjpeg on this machine: the native reader declines JPEG pages, and the"
              " JPEG slide of (j) and (k) decodes through the Python tile path (cv2); the"
              " lossless twin of (j) decodes natively")

    # (c) ------------------------------------------------------------------
    handle = get_registered_model(MODEL)
    spec = TransformSpec.from_config(handle.config.transform)
    std = np.asarray(spec.std, np.float32)
    scale = 1.0 / (255.0 * std)
    shift = -np.asarray(spec.mean, np.float32) / std
    rng = np.random.default_rng(SEED)
    print(f"(c) K1 vs its plain version ({MODEL} mean/std)")
    max_abs_err = 0.0
    for b, h, oh, skip in ((BATCH, 350, 224, 0), (BATCH, 175, 224, 0), (BATCH, 176, 224, 0),
                           (BATCH, 224, 224, 0), (BATCH, 350, 299, 0), (3, 97, 64, 0),
                           (BATCH + 1, 350, 224, 1)):
        # skip=1: x[1:] of a contiguous batch, whose first image is not 16-byte aligned
        x = torch.from_numpy(rng.integers(0, 256, (b, h, h, 3), dtype=np.uint8)).to(dev)[skip:]
        for dt in (torch.float32, torch.bfloat16):
            got = fused_preprocess(x, (oh, oh), scale, shift, dt)
            want = fused_preprocess_reference(x, (oh, oh), scale, shift, dt)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            levels = float((diff / torch.from_numpy(scale).to(dev)).max())
            share = float((got != want).float().mean())
            max_abs_err = max(max_abs_err, float(diff.max()))
            check(
                got.shape == (b - skip, oh, oh, 3) and torch.equal(got, want),
                f"B={b - skip} {h}->{oh} {str(dt)[6:]}{' from x[1:]' if skip else ''}:"
                f" max diff {levels:.3g} uint8 levels, share differing {share:.3g}"
                " (bit-identical: 0)",
            )
    del x, got, want, diff  # (d) reads the peak memory of its own tensors
    k1_shapes = []
    for h, oh in K1_TIMED:
        x = torch.from_numpy(rng.integers(0, 256, (BATCH, h, h, 3), dtype=np.uint8)).to(dev)
        for dt, nb in ((torch.bfloat16, 2), (torch.float32, 4)):
            ms = _cuda_ms(lambda: fused_preprocess(x, (oh, oh), scale, shift, dt), reps=50)
            plain_ms = _cuda_ms(
                lambda: fused_preprocess_reference(x, (oh, oh), scale, shift, dt), reps=5, warmup=1
            )
            bound_ms, bound_by = k1_bound(BATCH, h, h, oh, oh, nb, rates)
            nbytes = BATCH * (h * h * 3 + oh * oh * 3 * nb)
            k1_shapes.append({"shape": f"{h}->{oh}", "b": BATCH, "dtype": str(dt)[6:], "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                              "gb_s": nbytes / ms / 1e6})
            print(f"    K1 B={BATCH} {h}->{oh} {str(dt)[6:]}: {ms * 1e3:.1f} us/launch over 50,"
                  f" {nbytes / ms / 1e6:.0f} GB/s, bound {bound_ms * 1e3:.1f} us ({bound_by},"
                  f" {bound_ms / ms:.1%} of it), plain version {plain_ms:.3f} ms;"
                  " no library call computes it")
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
    check(launches["window_attention"] == 0, "K2 launches over the classifier path: 0")
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
    del data, engines, cpu_engine
    torch.cuda.empty_cache()

    # (f) ------------------------------------------------------------------
    print("(f) K2 vs its plain version")
    k2 = {"max_abs_err": 0.0, "shapes": []}
    for name, shape, dim, heads, window, rel, kb, dtypes, valid in K2_SHAPES:
        h, w = valid or shape
        for dt in (getattr(torch, d) for d in dtypes):
            qkv, rh, rw = k2_inputs(shape, dim, heads, window, rel, dt, dev, kb, rng)
            scale = (dim // heads) ** -0.5
            got = window_attention(qkv, heads, window, scale, rh, rw, valid)
            want = window_attention_reference(qkv, heads, window, scale, rh, rw, valid)
            torch.cuda.synchronize()
            got_real, want_real = got[:, :h, :w].float(), want[:, :h, :w].float()
            diff = (got_real - want_real).abs()
            atol, rtol = K2_TOL[str(dt)[6:]]
            excess = float((diff - atol - rtol * want_real.abs()).max())
            k2["max_abs_err"] = max(k2["max_abs_err"], float(diff.max()))
            check(got.shape == want.shape and bool(torch.isfinite(got_real).all())
                  and excess <= 0,
                  f"B={kb} {name} {str(dt)[6:]}: max |d| {float(diff.max()):.3g} on the"
                  f" {h}x{w} real rows (<= {atol:g} + {rtol:g}|x|)")
            ms = _cuda_ms(lambda: window_attention(qkv, heads, window, scale, rh, rw, valid),
                          reps=20)
            plain_ms = _cuda_ms(
                lambda: window_attention_reference(qkv, heads, window, scale, rh, rw, valid),
                reps=5, warmup=1)
            lib = sdpa_call(qkv, rh, rw, heads, window, scale)
            lib_ms = _cuda_ms(lib, reps=20)
            bound_ms, bound_by = k2_bound(qkv, rh, rw, heads, window, valid, rates)
            k2["shapes"].append({"shape": name, "b": kb, "dtype": str(dt)[6:], "valid": [h, w],
                                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "library_ms": lib_ms,
                                 "max_abs_err": float(diff.max())})
            print(f"    K2 B={kb} {name} {str(dt)[6:]}: {ms * 1e3:.1f} us/launch over 20, bound"
                  f" {bound_ms * 1e3:.1f} us ({bound_by} bound, {bound_ms / ms:.1%} of it),"
                  f" plain version {plain_ms:.3f} ms, scaled_dot_product_attention with the"
                  f" rel-pos mask at every row {lib_ms * 1e3:.1f} us")
            del qkv, rh, rw, got, want, diff, lib
    torch.cuda.empty_cache()

    # (g), (h) -------------------------------------------------------------
    cell = {}
    side = CELL_GRID * 164
    for phase, (model_name, per_batch) in zip("gh", CELL_MODELS):
        handle = get_registered_model(model_name)
        cfg = handle.config
        out_px = cfg.patch_size_pixels - 2 * cfg.halo_size_pixels
        t0 = time.perf_counter()
        data = rng.integers(0, 256, (CELL_BATCHES, CELL_BATCH, cfg.patch_size_pixels,
                                     cfg.patch_size_pixels, 3), dtype=np.uint8)
        # patch i's output lands on the canvas at grid cell (i // CELL_GRID, i % CELL_GRID)
        idx = np.arange(CELL_BATCHES * CELL_BATCH).reshape(CELL_BATCHES, CELL_BATCH)
        xy = np.stack([idx % CELL_GRID * out_px - cfg.halo_size_pixels,
                       idx // CELL_GRID * out_px - cfg.halo_size_pixels,
                       np.full_like(idx, cfg.patch_size_pixels),
                       np.full_like(idx, cfg.patch_size_pixels)], axis=-1)
        engines = {m: CellEngine(handle, mixed_precision=m, init_random=True, seed=SEED)
                   for m in (False, True)}
        print(f"({phase}) {model_name}: {CELL_BATCHES} batches of B={CELL_BATCH} seeded"
              f" {cfg.patch_size_pixels}px patches; two engines (seeded weights,"
              f" {sum(p.numel() for p in engines[False].model.parameters()) / 1e6:.1f} M"
              f" parameters) built in {time.perf_counter() - t0:.1f} s")
        stitchers, stats = {}, {}
        for mixed, engine in engines.items():
            warm = TileRemapStitcher(cfg.num_classes, side, side, out_px, cfg.halo_size_pixels,
                                     0.25, cfg.spacing_um_px)
            run_cells(engine, warm, data[:1], xy[:1])  # warm-up: cuDNN plans, pinned buffers
            st = TileRemapStitcher(cfg.num_classes, side, side, out_px, cfg.halo_size_pixels,
                                   0.25, cfg.spacing_um_px)
            torch.cuda.reset_peak_memory_stats()
            for fn in kernels:
                fn.launches = 0
            secs = run_cells(engine, st, data, xy)
            counts = {name: fn.launches for fn, name in kernels.items()}
            stitchers[mixed] = st
            x = engine.put(data[1])
            pred = engine.dispatch(x)
            fwd = _cuda_ms(lambda: engine.dispatch(x), reps=3)
            post = _cuda_ms(lambda: st.device_postprocess(pred), reps=10)
            share = k2_share(engine, x)
            mode = "bf16" if mixed else "parity"
            stats[mode] = {"patches_s": CELL_BATCHES * CELL_BATCH / secs,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "forward_ms": fwd, "post_ms": post, "k2_share": share,
                           "launches": counts}
            print(f"    {mode}: {stats[mode]['patches_s']:.1f} patches/s, peak"
                  f" {stats[mode]['peak_gib']:.2f} GiB; device per batch: forward {fwd:.2f} ms"
                  f" (K2 {share:.1%} of the forward's kernel time), post-process {post:.2f} ms")
            check(counts["window_attention"] == per_batch * CELL_BATCHES,
                  f"{mode}: K2 launches over the cell path {counts['window_attention']}"
                  f" ({per_batch} per batch x {CELL_BATCHES})")
            check(counts["fused_preprocess"] == 0, f"{mode}: K1 launches over the cell path 0")
            check(share > 0, f"{mode}: K2's share of the forward's kernel time {share:.1%}"
                  " (> 0: the trace finds K2's kernel by name)")
            del x, pred
        print(f"    {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")

        # (i) results, this model's part -----------------------------------
        cpu_engine = CellEngine(handle, init_random=True, seed=SEED, device="cpu")
        on_card = engines[False].run_batch(data[0, :2])
        on_host = cpu_engine.run_batch(data[0, :2])
        err = max(float((on_card[k].cpu() - on_host[k]).abs().max())
                  for k in ("nuclei_binary_map", "hv_map", "nuclei_type_map"))
        check(err <= 1e-3, f"(i) {model_name} parity on the card vs the CPU, 2 patches:"
              f" max |d| of the maps {err:.3g} (<= 1e-3)")
        p32, p16 = stitchers[False], stitchers[True]
        d_np = float(np.abs(p16.np_map - p32.np_map).max())
        d_hv = float(np.abs(p16.hv_map - p32.hv_map).max())
        d_tp = float(np.abs(p16.tp_map - p32.tp_map).max())
        np_flip = float(np.mean((p16.np_map > 0.5) != (p32.np_map > 0.5)))
        tp_flip = float(np.mean(p16.tp_map.argmax(-1) != p32.tp_map.argmax(-1)))
        check(np_flip <= 0.01, f"(i) {model_name} bf16 vs parity over {side}x{side} px: max |d|"
              f" NP {d_np:.3g}, HV {d_hv:.3g}, TP {d_tp:.3g}; NP > 0.5 differs on"
              f" {np_flip:.3%} (<= 1%), TP argmax on {tp_flip:.3%}")
        for mode, st in (("parity", p32), ("bf16", p16)):
            ok = all(bool(np.isfinite(m).all()) for m in (st.np_map, st.hv_map, st.tp_map))
            # uint8 transfer: each of K probabilities is within half a level
            tp_sum = float(np.abs(st.tp_map.sum(-1) - 1.0).max())
            check(ok and tp_sum <= cfg.num_classes * 0.5 / 255 + 1e-6,
                  f"(i) {model_name} {mode} canvas finite, TP rows sum to 1 within"
                  f" {tp_sum:.3g} (quantized transfer, <= K/2 levels)")
        exact = TileRemapStitcher(cfg.num_classes, side, side, out_px, cfg.halo_size_pixels,
                                  0.25, cfg.spacing_um_px, transfer_dtype="float32")
        maps = [m.cpu().numpy() for m in exact.device_postprocess(on_card)]
        tp_sum = float(np.abs(maps[2].sum(-1) - 1.0).max())
        check(all(np.isfinite(m).all() for m in maps) and tp_sum <= 1e-5,
              f"(i) {model_name} float32 maps finite, TP rows sum to 1 within {tp_sum:.3g}")
        cell[model_name] = stats
        if model_name == CELL_SLIDE_MODEL:  # kept for (l), on the host until then
            slide_engines = engines
            for engine in engines.values():
                engine.model.to("cpu")
        del data, engines, cpu_engine, stitchers, p32, p16, exact, on_card, on_host
        torch.cuda.empty_cache()

    # (j) ------------------------------------------------------------------
    slide = slide_phase(check, kernels, card, rng)

    # (l) ------------------------------------------------------------------
    for engine in slide_engines.values():
        engine.model.to(dev)
    cell_slide = cell_slide_phase(check, kernels, card, rng, slide_engines)
    del slide_engines
    torch.cuda.empty_cache()

    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed", file=sys.stderr)
        return 1
    # K1's headline: the main path's B=256 350->224 in bf16; every shape and
    # dtype is under "shapes".
    k1_main = k1_shapes[0]
    # K2's headline shape: SAM-H's windowed blocks in bf16, 28 of every 32
    # launches on the SAM-H path; every shape and dtype is under "shapes".
    k2_main = next(s for s in k2["shapes"]
                   if s["shape"] == "sam_h_windowed" and s["dtype"] == "bfloat16")
    k2_launches = sum(st["launches"]["window_attention"]
                      for stats in cell.values() for st in stats.values())
    k2_launches += cell_slide["k2_launches"]
    record = {"kernels": [{
        "name": "fused_preprocess",
        "route": "cuda",
        "source": "wsinsight_tpu_torch/ops/csrc/fused_preprocess.cu",
        "replaces": "wsinsight_tpu/ops/pallas_preprocess.py:38",
        "launches": launches["fused_preprocess"] + slide["k1_launches"],
        "max_abs_err": max_abs_err,
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
        "at": f"B={BATCH} {k1_main['shape']} {k1_main['dtype']}",
        "shapes": k1_shapes,
    }, {
        "name": "window_attention",
        "route": "cuda",
        "source": "wsinsight_tpu_torch/ops/csrc/window_attention.cu",
        "replaces": "wsinsight_tpu/ops/flash_attn.py:87",
        "launches": k2_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "at": f"B={CELL_BATCH} {k2_main['shape']} {k2_main['dtype']}",
        "shapes": k2["shapes"],
    }]}
    print(json.dumps({"cells": cell}))
    print(json.dumps({"slide": slide["stats"]}))
    print(json.dumps({"cell_slide": cell_slide["stats"]}))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
