#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wsinsight_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's two paths at full width and depth with seeded random
weights: patch classification with the zoo model breast-tumor-resnet34.
tcga-brca (350 px patches, resize 224, ResNet34, 2 classes) and the zoo's
other classifiers (VGG16, InceptionV4 with and without batch norm), and the
cell path with CellViT-SAM-H-x40 (ViT-H, 32 blocks, windowed and global
rel-pos attention; also over a whole slide to its nuclei), CellViT-256-x40
(ViT-S/16 with a cls token) and hovernet_fast_pannuke (HoVer-Net fast);
then StarDist's object-based patch stage and a classifier on its nuclei;
CellViT-Virchow-x40-AMP (Virchow's DINOv2 ViT-H/14); the banded streaming
cell engine over the nuclei slide; the analytics
(H-Plot, CME with its DGI training and the Leiden sweep, the H-Optimus-0
foundation branch); and the engines and the DGI over a device list of
replicas, slides over two host processes, and `models convert`. Holds every
hand-written kernel against its plain torch version. Phases; any failure exits non-zero and prints no result
line:

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
      row; SAM-H global; ViT-256's 257-token row; CellViT-Virchow's 325-token
      row, hd 80; H-Optimus' 261-token row, hd 64, at its B=64), and in bf16
      at SAM-B's 1024 px global block (B=1, n=4096); its time beside its bound (real
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
      against parity instances;
  (m) the zoo's other classifiers, device step alone: ClassifierEngine with
      seeded weights (make_random_local_model, seed 0) for
      breast-tumor-vgg16mod.tcga-brca (350 -> 224), breast-tumor-inception_v4.
      tcga-brca (350 -> 299) and pancancer-lymphocytes-inceptionv4.tcga (100
      px, Scale, InceptionV4 without batch norm), each in parity and bf16:
      10 batches of B=256 seeded uint8 patches with (d)'s two-deep window;
      patches/s, the whole step's and the preprocess's device ms (CUDA
      events), peak memory, K1 launches, each step's top kernels (profiler)
      and, beside InceptionV4, InceptionB's 1x7 / 7x1 convolutions alone
      against a 3x3 (B=256 at 17x17, f32 with TF32 off and bf16); checks:
      parity on the card vs the CPU (8 patches, 1e-3), bf16 vs parity (0.01
      for both InceptionV4s; VGG16's reported: the JAX package's own bf16
      drifts past 0.01 on its seeded weights), rows finite and summing to
      1, K1 launches equal to the bf16 batches for the first two and 0 for
      the lymphocyte model (Scale has no K1 form); then
      WSINSIGHT_PRECISION on (d)'s ResNet34 batches: "high" gives (d)'s parity
      probabilities bit for bit, "default" (TF32) stays within 0.01 of them;
  (n) (j)'s slide and plan through breast-tumor-inception_v4.tcga-brca in bf16
      (seeded): classify_slide -> the CSV -> write_geojsons (tiles) and
      write_omecsvs: patches/s and the device-busy share, each writer's
      seconds and bytes; checks: K1 launches equal to the batches, the
      GeoJSON one feature per CSV row with its prob_* as measurements and its
      box the CSV's shrunk by the CLI's overlap, the OME-CSV one row per CSV
      row under the JAX package's header. It runs after (k), before (l).
  (o) HoVer-Net (hovernet_fast_pannuke as the registry holds it: 256 px,
      halo 46, ToTensor alone; CellEngine with init_random, seed 0, 37.6 M
      parameters, whose NP head is then set from a probe, as (p) sets
      StarDist's: the head's input features projected on their mean inside
      (l)'s drawn nuclei less their mean outside, cut at the drawn nuclei's
      share; the seeded head's own bf16 flip share is printed beside it),
      parity and bf16: 8 batches of B=32 patches cut from the 2,716 px
      window of (l)'s slide with the most drawn nuclei (a 16 x 16 halo grid)
      through device_postprocess -> scatter as in (g): patches/s, device ms
      of the forward and of the post-process, peak memory, the forward's top
      four kernels and its layout conversions (cuDNN's NHWC <-> NCHW
      kernels; profiler), and d1-d3's first stride-2 conv alone (the TF-SAME
      F.pad and the conv, apart and together; CUDA events); checks: K1 and
      K2 launches 0, parity on the card vs
      the CPU (2 patches, maps <= 1e-3), parity's NP > 0.5 on 5-95% of the
      canvas, bf16 vs parity NP > 0.5 decisions agreeing on >= 99% of it,
      every map finite; then (l)'s slide through the halo grid ->
      stitch_slide -> finalize -> the CSV in bf16, with the HV head zeroed
      (as the CPU tests' end-to-end runs: each NP component one instance):
      patches/s without and with the finalize, device-busy share, the main
      thread's split, the finalize's seconds; checks as (l)'s (launches 0,
      lists aligned, polygons in their boxes, one CSV row per instance) and
      at least one instance;
  (p) StarDist on (l)'s slide (the written file): seeded StarDistUNet weights
      whose heads see the drawn nuclei (the prob head from a probe of the
      first block: the features' mean inside the drawn nuclei's inner halves
      less their mean outside any nucleus, its threshold the one of four
      whose NMS keeps the count nearest the block's drawn nuclei; rays of 12
      px with a
      seeded spread of 1.5 px; what was chosen is printed), written as
      stardist_2D_versatile_he.msgpack into a temporary WSINSIGHT_MODEL_DIR;
      plan_slide(object_based=True, object_detection="stardist") for the
      lymphocyte classifier's patch (100 px at 0.5 um/px): seconds of its
      stages as the library times them (utils.profiling.hot_stage, on for
      the whole script: the level-0 read, the percentile normalize, the
      tile's copy in, the forward, the maps' copy out, the candidates, the
      NMS), the forward per block by CUDA events (global module hooks);
      block count, candidates, nuclei kept (the plan's logged counts),
      coords, peak memory;
      the NMS on the drawn nuclei's own prob and dist maps (kept against
      drawn, share of drawn centres with a kept centre within 2 px); checks:
      4 blocks of 4224^2, 5,000-20,000 nuclei as closed 32-ray star polygons,
      K1 and K2 launches 0, the drawn maps' NMS keeping 80-105% of the drawn
      nuclei and finding >= 80% within 2 px, every stage timed (> 0 s), the
      forward on the card vs the CPU on a 512^2 tile (prob <= 1e-5, dist <=
      1e-3 px, and prob's pre-sigmoid logit within 1e-4 of the size of its
      terms, a bar that does not rest on the head's weights); then the plan's
      nuclei through pancancer-lymphocytes-inceptionv4.tcga made
      object-based with StarDist detection (seeded, bf16): classify_slide ->
      the CSV -> write_geojsons, checking one CSV row and one GeoJSON
      detection per planned nucleus, each nucleus's star polygon in the plan,
      and K1 and K2 launches 0 (Scale takes the torch preprocess). (o) and
      (p) run after (l); the record's kernels name them as paths that launch
      neither kernel.
  (q) CellViT-Virchow-x40-AMP as the registry holds it (ViT-H/14: 1280 wide,
      32 blocks, 16 heads, SwiGLU, LayerScale, the native 16x16 pos-embed
      resampled to 18x18; 256 px, halo 46), seeded (init_random: LayerScale
      gains U[0.1, 1]): as (g), 8 resident batches of B=32 in parity and
      bf16 (patches/s, forward device ms, K2 launches, 32 per batch, and its
      profiler share, peak memory) with (i)'s checks (card vs CPU <= 1e-3,
      bf16 NP decisions >= 99%, maps finite); then (l)'s slide through it in
      bf16: plan_slide (halo grid) -> stitch_slide -> finalize -> the CSV,
      with (l)'s checks (K2 32 per batch, K1 0, lists aligned, polygons in
      their boxes, one CSV row per instance). (f) holds K2 at its shape.
  (r) the analytics over (l)'s drawn nuclei (seeded PanNuke types around
      tumour nests, written in the cell CSV schema) and a second table of
      110,000 nuclei (above train_dgi_multi's 16,384-node cap, so the
      subgraph sampler runs) on a 256 px slide that carries the mpp:
      hplot_generation over both (host), cme_generation over both (cellular,
      300 DGI epochs on the card, the Leiden sweep with its kNN graph and
      silhouettes on the card): seconds of the graph build, the DGI (epochs/s),
      the full-graph embedding and the sweep (the library's hot_stage
      timers); then cme_generation, cellular and annotation, over a
      20,000-nucleus window of the large table (also above the cap): the
      Voronoi merge's seconds (the whole table's, host Python at under 1,000
      cells/s, would take minutes); one DGI step's loss on the
      card vs the CPU (<= 1e-4 relative); then H-Optimus-0 at full width and
      depth (ViT-g/14: 1536 wide, 40 blocks, 24 heads, 4 registers; seeded
      by zoo.randomize_weights, LayerScale gains U[0.1, 1]), card vs CPU on
      2 crops (<= 1e-3), and
      cme_generation(use_hoptimus=True) on (l)'s slide in bf16 over
      SlideCropSource's 224 px crops, cellular and annotation: crops/s on
      the card and over the whole foundation block, K2 launches (40 per
      batch of 64), the Voronoi merge's seconds; checks: the CME CSVs hold
      every cell once, the kept ones with one-hot cme_* columns, the regions
      WKT polygons, the H-Plot layer tables finite and its metrics finite
      but for the enrichment indices the JAX package leaves undefined,
      K1 launches 0.
  (s) (after (l), before (o)) the banded streaming cell engine
      (engine/stream_cells.py, run_cell_inference's default) over (l)'s
      slide and plan; first streaming_fits under the default budget at
      (l)'s, (j)'s and a 100,000 px wide slide's width, and the widest that
      streams; (1) the drawn nuclei's own maps, cut per patch into
      the model's logits (log(p + 1e-4)) by a stand-in engine, through
      stream_slide -> finalize on the card and through stitch_slide ->
      finalize (host-canvas), in the probed basin mode and with
      WSINSIGHT_STREAM_BASIN=host: seconds and instances; checks: the same
      instance set (boxes and polygons identical, probabilities within
      5e-3) and the host-canvas count within 2% of (l)'s on the painted
      canvas; then with the per-band id cap forced to 2,
      StreamingCapacityError on the main thread and no flusher left alive;
      (2) (g)'s bf16 SAM-H with its NP head reading the drawn nuclei (a
      discriminant of decoder0's features fit on a probe of 64 of the
      plan's patches, sam_heads_from_drawn) and its HV head zeroed (the
      seeded heads find one instance), through
      the host-canvas engine (run_cell_slide) and then through
      PatchBatchSource.from_coords (order_by_y) -> stream_slide -> finalize:
      each engine's patches/s with everything included, its instances, the
      device-busy share and the main thread's split; for streaming also the
      rate over the loop, the engine's hot_stage seconds, each band's flush
      on the host clock against the loop's end, the bands' bytes, peak
      device memory, host RSS growth, the link probe and the basin it
      picked; checks: streaming_fits at this geometry, no
      StreamingCapacityError, each engine at least a tenth of the drawn
      nuclei's count in instances, K2 launches 32 per batch and K1 0 in
      both, the hot stages timed, (l)'s CSV checks (rows summing to 1
      within K half-ulps of bf16); reported, not checked: the streaming
      instances' boxes against host-canvas's; (3) the whole plan again
      under WSINSIGHT_PROFILE (utils.profiling.maybe_trace): the trace's
      CUDA kernels per stream, the share of the flushers' kernel time that
      overlaps the forward stream's and that ran before its last kernel;
      checks: one trace with kernel events, K2's among them, and K2
      launches 32 per batch.
  (t) (after (m)) the engines and the DGI on a device list naming the card
      twice (``devices=["cuda:0", "cuda:0"]``: two replicas, each batch split
      in two and gathered on the first), and several hosts: the default
      device list's cards; (d)'s ResNet34 batches in parity and bf16 on two
      replicas and on one (patches/s of both, reported); CellViT-256-x40 at
      B=32 in parity on two replicas and on one over 4 seeded batches;
      two processes on the card under a coordinator on 127.0.0.1 (a free
      port) sharing 4 seeded 1,400 px slides through shard_slides_for_host
      and classify_slide on in-memory plans; (d)'s torch checkpoint through
      `models convert --report` to a flax msgpack and classified; the DGI
      over 3 small graphs (padded to 4) on two card replicas and on two CPU
      ones; checks: the default list is every visible card, parity on two
      replicas within 1e-5 of one, bf16 on two within 0.01 of parity, K1
      launches two per bf16 batch, CellViT-256's maps within 1e-4 of one
      replica's and its K2 launches doubled, each slide classified once by
      one process and the union's probabilities one process's bit for bit
      (a child that fails fails the phase), the converted msgpack's
      probabilities the state dict's bit for bit, and the DGI's loss and
      weights within 1e-4 relative of the CPU's.
After the last phase the script prints each phase's seconds on the host
clock ("phase seconds"), pass or fail. The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}, printed exactly when every phase passed, and
then the script exits 0; otherwise it exits 1 (also where CUDA is missing or
the port's package is not beside it). Imports nothing of JAX.
"""

from __future__ import annotations

import json
import logging
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
# K2 at the cell path's shapes, B=32 in both dtypes, SAM-B's global block at
# 1024 px (n=4096, 64 key tiles) at B=1 in bf16, and the analytics' H-Optimus
# at its batch of 64: (name, qkv grid HP x WP, dim, heads, window, rel-pos, B,
# dtypes, valid). SAM-H's windowed blocks run on its 16x16 grid padded to
# 28x28.
K2_SHAPES = (
    ("sam_h_windowed", (28, 28), 1280, 16, 14, True, CELL_BATCH, ("float32", "bfloat16"),
     (16, 16)),
    ("sam_h_windowed_all_rows", (28, 28), 1280, 16, 14, True, CELL_BATCH, ("float32",), None),
    ("sam_h_global", (16, 16), 1280, 16, 0, True, CELL_BATCH, ("float32", "bfloat16"), None),
    ("vit_256", (1, 257), 384, 6, 0, False, CELL_BATCH, ("float32", "bfloat16"), None),
    ("sam_b_1024_global", (64, 64), 768, 12, 0, True, 1, ("bfloat16",), None),
    # (q)'s CellViT-Virchow at 256 px: cls + 18x18 tokens, hd 80; (r)'s
    # H-Optimus-0 at 224 px: cls + 4 registers + 16x16 tokens, hd 64
    ("virchow", (1, 325), 1280, 16, 0, False, CELL_BATCH, ("float32", "bfloat16"), None),
    ("hoptimus", (1, 261), 1536, 24, 0, False, 64, ("float32", "bfloat16"), None),
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


class PhaseClock:
    """Host seconds of each phase of main: a phase runs from its mark to the
    next mark (the last to ``seconds``' call)."""

    def __init__(self):
        self.marks: list[tuple[str, float]] = []

    def __call__(self, name: str) -> None:
        self.marks.append((name, time.perf_counter()))

    def seconds(self) -> dict:
        ends = [t for _, t in self.marks[1:]] + [time.perf_counter()]
        return {name: round(end - t, 1) for (name, t), end in zip(self.marks, ends)}


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

    # (n) ------------------------------------------------------------------
    t_n = time.perf_counter()
    exports = exports_phase(check, kernels, card, path, plan, workers, tmp.name)
    print(f"    (n) took {time.perf_counter() - t_n:.1f} s")
    stats["exports"] = exports["stats"]
    tmp.cleanup()
    tmp_model.cleanup()
    return {"stats": stats, "k1_launches": k1_launches + exports["k1_launches"]}


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


def cell_slide_phase(check, kernels, card, rng, engines, cell_slide) -> dict:
    """(l): a synthetic slide with nuclei through the cell path: plan_slide
    (halo grid) -> PatchBatchSource -> stitch_slide -> finalize -> the CSV,
    with CellViT-SAM-H-x40 in parity and bf16; the native watershed against
    the Python one and the ridge on the card against the cv2 path, on the
    parity canvases and on the drawn nuclei's own maps. ``cell_slide`` is
    write_nuclei_slide's (path, tissue share, nuclei, seconds)."""
    from wsinsight_tpu_torch.cli.infer import default_infer_workers, default_stitch_workers
    from wsinsight_tpu_torch.ops.watershed import _watershed_python, watershed
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils.workers import governed_workers

    tmp = tempfile.TemporaryDirectory()
    path, tissue, nuclei, secs = cell_slide
    side = CELL_SLIDE_PX
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
        slide_csv_checks(check, f"(l) {mode}", engine, out, f"{tmp.name}/{mode}.csv")
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
    # (s) streams the same plan and the drawn nuclei's maps
    return {"stats": stats, "k2_launches": k2_launches, "coords": plan.coords, "patch_size": ps,
            "dims": dims, "workers": workers, "stitch_workers": stitch_workers,
            "results": results, "drawn": drawn, "drawn_maps": (st.np_map, st.hv_map, st.tp_map)}


class PlanBatches:
    """A plan's patches in slide-row order, as PatchBatchSource yields them
    with order_by_y, but carrying each patch's index in the plan where the
    pixels would be (for DrawnEngine)."""

    def __init__(self, coords, patch_size: int, batch: int):
        self.coords, self.patch_size, self.batch = coords, patch_size, batch
        self.order = np.lexsort((coords[:, 0], coords[:, 1]))
        self.num_batches = -(-len(coords) // batch)

    def __iter__(self):
        from wsinsight_tpu_torch.engine.data import Batch

        ps = self.patch_size
        for i0 in range(0, len(self.order), self.batch):
            idx = self.order[i0:i0 + self.batch]
            xy = self.coords[idx].astype(np.int64)
            yield Batch(images=idx, coords=np.concatenate([xy, np.full_like(xy, ps)], axis=1),
                        n_valid=len(idx))


class DrawnEngine:
    """A stand-in for a CellEngine (config, device, put, dispatch) whose
    forward returns, for each patch of a PlanBatches batch, the drawn
    nuclei's own maps over the patch's output window as the model's
    channel-first logits: NP and TP as log(p + 1e-4), HV as drawn."""

    def __init__(self, engine, maps, coords, dev):
        self.config, self.device, self.coords = engine.config, dev, coords
        self.n_devices = 1
        cfg = engine.config
        self.s = cfg.patch_size_pixels - 2 * cfg.halo_size_pixels  # model mpp = slide mpp
        self.shift = cfg.halo_size_pixels + self.s  # the maps are padded by s all round
        pad = ((self.s, self.s), (self.s, self.s))
        self.maps = [np.pad(m, pad + ((0, 0),) * (m.ndim - 2)) for m in maps]

    def pad_batch(self, n: int) -> int:
        return n

    def put(self, idx):
        return idx

    def dispatch(self, idx) -> dict:
        import torch

        s = self.s
        xy = self.coords[idx].astype(np.int64) + self.shift
        np_p, hv, tp = (np.stack([m[y:y + s, x:x + s] for x, y in xy]) for m in self.maps)
        eps = 1e-4
        np_logits = np.stack([np.log1p(-np_p + eps), np.log(np_p + eps)], axis=1)
        out = {"np": np_logits, "hv": hv.transpose(0, 3, 1, 2),
               "tp": np.log(tp + eps).transpose(0, 3, 1, 2)}
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(self.device)
                for k, v in out.items()}


def sam_heads_from_drawn(engine, drawn, path, coords, ps, workers) -> dict:
    """Make the SAM-H engine's NP head read the drawn nuclei, and zero its HV
    head. The seeded heads find one instance on (l)'s slide, which would
    leave the engines' finalize no per-instance work; a projection of the
    NP head's own input features, as (o) sets HoVer-Net's, agrees with the
    drawn nuclei on fewer pixels than "all background" does here. So the
    head's first two blocks carry one projection of ``decoder0``'s features
    (two convolutions over the patch's pixels) instead: Fisher's
    discriminant between the drawn nuclei and the rest on a probe of 2
    batches of the plan's patches, spread over it, scaled to a spread of 4
    and cut at the drawn nuclei's share of the probe, as +/- channels
    through the ReLUs; the last 1x1 takes their difference as the
    foreground logit (background 0). Every layer still runs. The HV head
    is zeroed, as in (o) and the CPU tests' end-to-end runs: a zero field
    leaves each NP component one instance. ``drawn`` is (s)(1)'s
    DrawnEngine (the drawn maps, cut per patch)."""
    import torch

    from wsinsight_tpu_torch.engine.data import PatchBatchSource

    dec = engine.model.nuclei_binary_map_decoder
    step = max(1, len(coords) // (2 * CELL_BATCH))
    idx = np.arange(0, len(coords), step)[:2 * CELL_BATCH]
    h, s = engine.config.halo_size_pixels, drawn.s
    got, feats, masks = [], [], []
    hook = dec.decoder0.register_forward_hook(lambda m, i, o: got.append(
        o[:, :, h:h + s, h:h + s].float().permute(0, 2, 3, 1).reshape(len(o), -1, o.shape[1])))
    src = PatchBatchSource.from_coords(path, coords[idx], ps, CELL_BATCH, num_threads=workers,
                                       decode_scale=1)
    try:
        for batch in src:
            n = batch.n_valid
            got.clear()
            engine.run_batch(batch.images)
            feats.append(got[0][:n].reshape(-1, got[0].shape[-1]))
            xy = batch.coords[:n, :2].astype(np.int64) + drawn.shift
            masks.append(np.stack([drawn.maps[0][y:y + s, x:x + s] >= 0.5 for x, y in xy]))
    finally:
        hook.remove()
        src.close()
    mask = np.concatenate(masks).ravel()
    share = float(mask.mean())
    with torch.inference_mode():
        f = torch.cat(feats).double()
        inside = torch.from_numpy(mask).to(f.device)
        cov = torch.cov(f[inside].T) + torch.cov(f[~inside].T)
        ridge = 1e-3 * cov.diagonal().mean() * torch.eye(len(cov), dtype=f.dtype, device=f.device)
        w = torch.linalg.solve(cov + ridge, f[inside].mean(0) - f[~inside].mean(0))
        proj = (f @ w).cpu().numpy()
    del f, feats
    scale = 4.0 / float(proj.std())
    thr = float(np.quantile(proj, 1 - share))
    first, second, last = dec.decoder0_header
    hv = engine.model.hv_map_decoder.decoder0_header[-1]
    with torch.no_grad():
        for blk in (first, second):
            blk.conv.weight.zero_()
            blk.conv.bias.zero_()
            blk.bn.running_mean.zero_()
            blk.bn.running_var.fill_(1.0)
            blk.bn.weight.fill_(float(np.sqrt(1.0 + blk.bn.eps)))
            blk.bn.bias.zero_()
        wk = (w * scale).to(first.conv.weight)
        first.conv.weight[0, :len(wk), 1, 1] = wk
        first.conv.weight[1, :len(wk), 1, 1] = -wk
        first.conv.bias[0] = -thr * scale
        first.conv.bias[1] = thr * scale
        second.conv.weight[0, 0, 1, 1] = 1.0
        second.conv.weight[1, 1, 1, 1] = 1.0
        last.weight.zero_()
        last.bias.zero_()
        last.weight[1, 0, 0, 0] = 1.0
        last.weight[1, 1, 0, 0] = -1.0
        hv.weight.zero_()
        hv.bias.zero_()
    return {"probe_patches": len(idx), "foreground_share": share, "logit_scale": scale,
            "agrees_with_drawn_on_probe": float(np.mean((proj > thr) == mask))}


def flush_overlap(flushes, loop_end: float) -> dict:
    """The flushers' host seconds (``flushes``: (band, start, end) on the
    host clock, one per _flush_band) and the share of them spent before the
    batch loop ended at ``loop_end``: the finalize work that overlapped the
    forwards."""
    total = sum(e - s for _, s, e in flushes)
    within = sum(max(0.0, min(e, loop_end) - s) for _, s, e in flushes)
    return {"flush_s": total, "flush_s_during_loop": within,
            "share_during_loop": within / total if total else float("nan"),
            "bands": {int(b): {"start_s": s - loop_end, "end_s": e - loop_end}
                      for b, s, e in sorted(flushes)}}


def kernel_streams(trace_path: str) -> dict:
    """CUDA kernels of a torch.profiler Chrome trace, per stream: the
    forward's stream is the one K2 ran on; the others are the flushers'.
    Returns counts, the share of the flushers' kernel time that overlaps the
    forward stream's busy time, and the share that ran before the forward
    stream's last kernel ended (during the batch loop)."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    by_stream: dict = {}
    for e in events:
        by_stream.setdefault(e.get("args", {}).get("stream"), []).append(e)
    main = next((st for st, evs in by_stream.items()
                 if any("window_attention_kernel" in e["name"] for e in evs)), None)
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in by_stream.get(main, []))
    merged: list = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = np.array([m[0] for m in merged]) if merged else np.zeros(0)
    fwd_end = merged[-1][1] if merged else 0.0
    flush_us = overlap_us = before_us = 0.0
    for st, evs in by_stream.items():
        if st == main:
            continue
        for e in evs:
            a, b = e["ts"], e["ts"] + e["dur"]
            flush_us += b - a
            before_us += max(0.0, min(b, fwd_end) - a)
            i = int(np.searchsorted(starts, b)) - 1
            while i >= 0 and merged[i][1] > a:
                overlap_us += min(b, merged[i][1]) - max(a, merged[i][0])
                i -= 1
    nan = float("nan")
    return {"kernels": len(events), "streams": {str(k): len(v) for k, v in by_stream.items()},
            "forward_stream": main, "flusher_kernel_ms": flush_us / 1e3,
            "flusher_overlap": overlap_us / flush_us if flush_us else nan,
            "flusher_before_forward_end": before_us / flush_us if flush_us else nan}


def stream_phase(check, kernels, card, engines, cell_slide, l_out) -> dict:
    """(s): the banded streaming engine (engine/stream_cells.py) over (l)'s
    slide, plan and bf16 SAM-H engine: (1) the drawn nuclei's maps through
    it and through the host-canvas engine, (2) the real forward through it,
    (3) one run under WSINSIGHT_PROFILE."""
    import psutil
    import torch

    import wsinsight_tpu_torch.engine.stream_cells as sc
    from wsinsight_tpu_torch.engine.cells import make_slide_stitcher, stitch_slide
    from wsinsight_tpu_torch.engine.data import PatchBatchSource
    from wsinsight_tpu_torch.utils.profiling import hot_stage_report, maybe_trace

    t_phase = time.perf_counter()
    path = cell_slide[0]
    coords, ps, dims = l_out["coords"], l_out["patch_size"], l_out["dims"]
    workers, stitch_workers = l_out["workers"], l_out["stitch_workers"]
    engine = engines[True]
    dev = engine.device
    cfg = engine.config
    n_flushers = sc.pick_num_flushers(stitch_workers)
    s_px = cfg.patch_size_pixels - 2 * cfg.halo_size_pixels
    fits = sc.streaming_fits(dims[0], cfg.num_classes, s_px, num_flushers=n_flushers)
    buf_h, buf_w = sc.STREAM_TILE + 2 * sc.STREAM_PAD + 2 * s_px, dims[0] + 2 * s_px
    band_bytes = buf_h * buf_w * (3 + cfg.num_classes) * 2
    mbps = sc._d2h_mbps(dev)
    print(f"(s) the banded streaming engine over (l)'s slide: {n_flushers} flusher(s) (the CLI's"
          f" --stitch-workers {stitch_workers}), bands of {buf_h} x {buf_w} px x"
          f" {3 + cfg.num_classes} bf16 channels = {band_bytes / 1e6:.1f} MB, at most"
          f" {3 + 2 * n_flushers + 1} alive: {(3 + 2 * n_flushers + 1) * band_bytes / 2**30:.2f}"
          f" GiB of the {6:d} GiB budget; link probe {mbps:.0f} MB/s device -> host, so the"
          f" {'device' if mbps >= 250 else 'host'} basin by default; {card}")
    check(fits, f"(s) streaming_fits at (l)'s geometry with {n_flushers} flusher(s):"
          " run_cell_inference takes the streaming engine")
    # the budget at other widths: (j)'s slide, and a 40x whole slide of
    # 25 x 25 mm (100,000 px); wider slides take the host-canvas engine
    alive = 3 + 2 * n_flushers + 1
    budget = {name: {"width": width,
                     "bands_gib": alive * buf_h * (width + 2 * s_px) * (3 + cfg.num_classes) * 2
                     / 2**30,
                     "fits": sc.streaming_fits(width, cfg.num_classes, s_px,
                                               num_flushers=n_flushers)}
              for name, width in (("(l)", dims[0]), ("(j)", SLIDE_PX), ("40x WSI", 100_000))}
    widest = {}
    for nf in (n_flushers, 1):
        lo, hi = 0, 1 << 20
        while lo < hi:  # the widest slide streaming_fits admits
            mid = (lo + hi + 1) // 2
            ok = sc.streaming_fits(mid, cfg.num_classes, s_px, num_flushers=nf)
            lo, hi = (mid, hi) if ok else (lo, mid - 1)
        widest[nf] = lo
    print("    streaming_fits under the 6 GiB default: " + "; ".join(
        f"{k} {v['width']} px wide: bands {v['bands_gib']:.2f} GiB,"
        f" {'streams' if v['fits'] else 'host-canvas'}" for k, v in budget.items())
          + f"; the widest that streams: {widest[n_flushers]} px at {n_flushers} flushers,"
          f" {widest[1]} px at 1")
    budget["widest"] = widest
    stats = {"flushers": n_flushers, "band_bytes": band_bytes, "d2h_mbps": mbps,
             "fits": fits, "budget": budget, "card": card}

    # (1) the drawn nuclei's maps, streaming against host-canvas ------------
    drawn_engine = DrawnEngine(engine, l_out["drawn_maps"], coords, dev)
    src = PlanBatches(coords, ps, CELL_BATCH)
    t0 = time.perf_counter()
    st = make_slide_stitcher(drawn_engine, dims[0], dims[1], SLIDE_MPP, cfg.halo_size_pixels)
    try:
        stitch_slide(drawn_engine, st, src)
        host = st.finalize(num_workers=stitch_workers)
    finally:
        st.close()
    host_s = time.perf_counter() - t0
    n_l = l_out["drawn"][0]
    print(f"    (1) drawn maps, host-canvas engine (stitch_slide -> finalize): {len(host[0])}"
          f" instances in {host_s:.2f} s ((l) painted on the canvas: {len(n_l)})")
    check(abs(len(host[0]) - len(n_l)) <= 0.02 * len(n_l),
          f"(s) drawn maps through the host-canvas engine: {len(host[0])} instances, within 2%"
          f" of (l)'s {len(n_l)} on the painted canvas")
    stats["drawn"] = {"host_canvas": {"instances": len(host[0]), "seconds": host_s}}
    for basin in ("", "host"):
        name = basin or "probed"
        if basin:
            os.environ["WSINSIGHT_STREAM_BASIN"] = basin
        try:
            t0 = time.perf_counter()
            bst = sc.make_banded_stitcher(drawn_engine, dims[0], dims[1], SLIDE_MPP,
                                          cfg.halo_size_pixels, num_flushers=n_flushers)
            try:
                sc.stream_slide(drawn_engine, bst, src)
                out = bst.finalize()
            finally:
                bst.close()
            secs = time.perf_counter() - t0
        finally:
            os.environ.pop("WSINSIGHT_STREAM_BASIN", None)
        same, dp = same_instances(out, host)
        mode = "device" if bst._basin_device else "host"
        print(f"    (1) drawn maps, streaming engine, {name} basin ({mode}):"
              f" {len(out[0])} instances in {secs:.2f} s")
        check(same and dp <= 5e-3, f"(s) drawn maps, {name} basin ({mode}): streaming gives the"
              f" host-canvas engine's instance set ({len(out[0])}, boxes and polygons identical),"
              f" max |dp| {dp:.3g} (<= 5e-3)")
        stats["drawn"][name] = {"basin": mode, "instances": len(out[0]), "seconds": secs,
                                "same": same, "max_abs_dp": dp}
    # the capacity reroute's trigger on the card: a per-band id cap of 2
    cap = sc._MAX_IDS
    sc._MAX_IDS = 2
    raised = None
    try:
        bst = sc.make_banded_stitcher(drawn_engine, dims[0], dims[1], SLIDE_MPP,
                                      cfg.halo_size_pixels, num_flushers=n_flushers)
        try:
            sc.stream_slide(drawn_engine, bst, src)
            bst.finalize()
        except sc.StreamingCapacityError as err:
            raised = str(err)
        finally:
            bst.close()
    finally:
        sc._MAX_IDS = cap
    alive_flushers = sum(t.is_alive() for t in bst._flushers)
    print(f"    (1) drawn maps, streaming engine with a per-band id cap of 2: {raised!r};"
          f" {alive_flushers} flusher(s) alive after close()")
    check(raised is not None and alive_flushers == 0,
          "(s) drawn maps with _MAX_IDS = 2: StreamingCapacityError reaches the main thread"
          " (run_cell_inference's reroute to the host-canvas engine) and close() ends the"
          " flushers")
    stats["drawn"]["capacity_error"] = raised

    # (2) the real forward: SAM-H bf16 over the plan, both engines ----------
    n_drawn = len(cell_slide[2][0])
    head = sam_heads_from_drawn(engine, drawn_engine, path, coords, ps, workers)
    print(f"    (2) SAM-H's NP head reads decoder0's features through Fisher's discriminant of"
          f" the drawn nuclei on a probe of {head['probe_patches']} patches, its HV head zeroed:"
          f" {head}")
    stats["heads"] = head
    del drawn_engine, out, host
    host_st, host_out, host_run = run_cell_slide(engine, kernels, path, coords, ps, dims,
                                                 workers, stitch_workers)
    host_st.close()
    hs = host_run["host_shares"]
    print(f"    (2) SAM-H bf16, host-canvas engine: {host_run['patches_s']:.1f} patches/s without"
          f" the finalize ({host_run['wall_s']:.2f} s), {host_run['patches_s_with_finalize']:.1f}"
          f" with it (finalize {host_run['finalize_s']:.2f} s on {stitch_workers} worker(s));"
          f" device busy {host_run['busy']:.1%}; peak {host_run['peak_gib']:.2f} GiB; foreground"
          f" {host_run['foreground']:.2%}; {host_run['instances']} instances ({n_drawn} nuclei"
          f" drawn); {card}")
    print(f"    (2) host-canvas main thread, share of the loop: waiting for decoded batches"
          f" {hs['decode_wait']:.1%}, put {hs['put']:.1%}, dispatch {hs['dispatch']:.1%},"
          f" scatter {hs['scatter']:.1%}, the rest {1 - sum(hs.values()):.1%}")
    check(host_run["instances"] >= n_drawn // 10, f"(s) host-canvas run: {host_run['instances']}"
          f" instances, at least a tenth of the {n_drawn} drawn nuclei (the finalize has"
          " per-instance work)")
    check(host_run["launches"] == {"fused_preprocess": 0,
                                   "window_attention": 32 * host_run["batches"]},
          f"(s) host-canvas run: K1 and K2 launches {host_run['launches']} (0, 32 per batch)")
    stats["host_canvas"] = host_run
    proc = psutil.Process()
    plain = engine.put, engine.dispatch
    window = Window(engine)
    window.host["accumulate"] = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    hot_stage_report(reset=True)
    rss0 = proc.memory_info().rss
    t0 = time.perf_counter()
    bst = sc.make_banded_stitcher(engine, dims[0], dims[1], SLIDE_MPP, cfg.halo_size_pixels,
                                  num_flushers=n_flushers)
    accumulate, flush_band, flushes = bst.accumulate_batch, bst._flush_band, []

    def timed_accumulate(*args, **kw):
        t = time.perf_counter()
        accumulate(*args, **kw)
        window.host["accumulate"] += time.perf_counter() - t

    def timed_flush(b, *args, **kw):
        t = time.perf_counter()
        try:
            flush_band(b, *args, **kw)
        finally:
            flushes.append((b, t, time.perf_counter()))

    bst.accumulate_batch, bst._flush_band = timed_accumulate, timed_flush
    src = PatchBatchSource.from_coords(path, coords, ps, CELL_BATCH, num_threads=workers,
                                       order_by_y=True, decode_scale=1)
    try:
        try:
            sc.stream_slide(engine, bst, src, window.batches(src))
        finally:
            src.close()
            engine.put, engine.dispatch = plain
        loop_s = time.perf_counter() - t0
        rss_loop = proc.memory_info().rss
        out = bst.finalize()
        torch.cuda.synchronize()
    except sc.StreamingCapacityError as err:
        check(False, f"(s) the streaming run was not rerouted: {err}")
        raise
    finally:
        bst.close()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for fn, name in kernels.items()}
    stages = hot_stage_report(reset=True)
    n, n_batches = len(coords), src.num_batches
    host_shares = {k: v / loop_s for k, v in window.host.items()}
    run = {"patches": n, "batches": n_batches, "patches_s": n / wall,
           "patches_s_loop": n / loop_s, "wall_s": wall, "loop_s": loop_s,
           "finalize_wait_s": wall - loop_s, "busy": window.device_s() / wall,
           "busy_loop": window.device_s() / loop_s, "host_shares": host_shares,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "rss_growth_gb": (rss_loop - rss0) / 1e9, "instances": len(out[0]),
           "basin": "device" if bst._basin_device else "host", "launches": launches,
           "hot_stages": stages,
           "flushes": flush_overlap(flushes, t0 + loop_s)}
    stats["forward"] = run
    fo = run["flushes"]
    print(f"    (2) SAM-H bf16, streaming engine: {run['patches_s']:.1f} patches/s with everything"
          f" included ({wall:.2f} s: loop {loop_s:.2f} s, then {run['finalize_wait_s']:.2f} s for"
          f" the last bands), {run['patches_s_loop']:.1f} over the loop; device busy"
          f" {run['busy']:.1%} of the wall time ({run['busy_loop']:.1%} of the loop); peak"
          f" {run['peak_gib']:.2f} GiB on the card; host RSS grew {run['rss_growth_gb']:.2f} GB"
          f" over the loop; {run['basin']} basin; {len(out[0])} instances; {card}")
    host_run["busy_with_finalize"] = host_run["busy"] * host_run["wall_s"] / (
        host_run["wall_s"] + host_run["finalize_s"])
    print(f"    (2) host-canvas for the same: {host_run['patches_s_with_finalize']:.1f} patches/s"
          f" with everything included, device busy {host_run['busy_with_finalize']:.1%} of that"
          f" wall time; {host_run['instances']} instances")
    print(f"    (2) streaming main thread, share of the loop: waiting for decoded batches"
          f" {host_shares['decode_wait']:.1%}, put {host_shares['put']:.1%}, dispatch"
          f" {host_shares['dispatch']:.1%}, accumulate {host_shares['accumulate']:.1%}, the"
          f" rest {1 - sum(host_shares.values()):.1%}")
    print("    (2) hot_stage seconds (all threads): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"    (2) the flushers: {fo['flush_s']:.2f} s in _flush_band over {len(fo['bands'])}"
          f" band(s), {fo['share_during_loop']:.1%} of it before the loop ended; per band"
          f" (start, end) in s from the loop's end: " + "; ".join(
              f"{b}: ({v['start_s']:+.2f}, {v['end_s']:+.2f})" for b, v in fo["bands"].items()))
    k2 = launches["window_attention"]
    check(k2 == 32 * n_batches, f"(s) K2 launches {k2} (32 per batch x {n_batches} batches)")
    check(launches["fused_preprocess"] == 0, "(s) K1 launches 0")
    check(any(k.startswith("flush.") for k in stages) and stages.get(
        "accumulate.scatter_dispatch", 0) > 0, "(s) the engine's hot stages timed (accumulate"
          " and flush)")
    check(len(out[0]) >= n_drawn // 10, f"(s) streaming run: {len(out[0])} instances, at least a"
          f" tenth of the {n_drawn} drawn nuclei (the flushers have per-instance work)")
    slide_csv_checks(check, "(s) streaming", engine, out, f"{tempfile.gettempdir()}/s.csv",
                     bf16_maps=True)
    hb = {tuple(b[0]) for b in host_out[0]}
    shared = sum(tuple(b[0]) in hb for b in out[0])
    run["bbox_share_of_host_canvas"] = shared / max(1, len(hb))
    print(f"    (2) streaming against host-canvas on the same heads (not checked): {len(out[0])}"
          f" against {len(hb)} instances, {shared} bboxes in both"
          f" ({run['bbox_share_of_host_canvas']:.2%} of host-canvas's)")
    del host_out

    # (3) one run under WSINSIGHT_PROFILE ------------------------------------
    prof_dir = tempfile.TemporaryDirectory()
    for fn in kernels:
        fn.launches = 0
    os.environ["WSINSIGHT_PROFILE"] = prof_dir.name
    t0 = time.perf_counter()
    try:
        with maybe_trace("stream_cells"):
            bst = sc.make_banded_stitcher(engine, dims[0], dims[1], SLIDE_MPP,
                                          cfg.halo_size_pixels, num_flushers=n_flushers)
            src = PatchBatchSource.from_coords(path, coords, ps, CELL_BATCH,
                                               num_threads=workers, order_by_y=True,
                                               decode_scale=1)
            try:
                sc.stream_slide(engine, bst, src)
                bst.finalize()
            finally:
                src.close()
                bst.close()
    finally:
        del os.environ["WSINSIGHT_PROFILE"]
    prof_s = time.perf_counter() - t0
    traces = [os.path.join(d, f) for d, _, fs in os.walk(prof_dir.name) for f in fs
              if f.endswith(".pt.trace.json")]
    streams = kernel_streams(traces[0]) if len(traces) == 1 else {"kernels": 0}
    streams.update(seconds=prof_s, trace_mb=os.path.getsize(traces[0]) / 1e6 if traces else 0,
                   k2_launches={n: fn.launches for fn, n in kernels.items()}["window_attention"])
    prof_dir.cleanup()
    stats["profile"] = streams
    nan = float("nan")
    print(f"    (3) WSINSIGHT_PROFILE over the whole plan ({n} patches, {n_batches} batches):"
          f" {prof_s:.2f} s, trace {streams['trace_mb']:.1f} MB, {streams['kernels']} CUDA kernel"
          f" events; per stream {streams.get('streams')}; the flushers' kernels"
          f" {streams.get('flusher_kernel_ms', nan):.2f} ms, of which"
          f" {streams.get('flusher_overlap', nan):.1%} overlap the forward stream's kernels and"
          f" {streams.get('flusher_before_forward_end', nan):.1%} ran before its last one ended")
    check(len(traces) == 1 and streams["kernels"] > 0
          and streams.get("forward_stream") is not None,
          f"(s) WSINSIGHT_PROFILE wrote one torch.profiler trace under <dir>/stream_cells/ with"
          f" CUDA kernel events ({streams['kernels']}), K2's among them")
    check(streams["k2_launches"] == 32 * n_batches, f"(s) profiled run: K2 launches"
          f" {streams['k2_launches']} (32 per batch x {n_batches})")
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"    (s) took {stats['seconds']:.1f} s")
    k2_host = host_run["launches"]["window_attention"]
    return {"stats": stats, "k2_launches": k2_host + k2 + streams["k2_launches"]}


# (m): the zoo's other classifiers, with seeded weights (seed SEED):
# (model, architecture, Resize, whether K1 runs in bf16, whether bf16 is held
# to the 0.01 bar against parity). The lymphocyte model's Scale transform has
# no K1 form, so it takes the torch preprocess. VGG16's bf16 drift is
# reported, not checked: its seeded logits are large (no batch norm), and
# near p = 0.5 bf16 moves a probability past 0.01 in the JAX package as in
# the port (tests/test_torch_zoo_classifiers.py::
# test_vgg16_bf16_drift_is_the_jax_packages holds the port to the JAX
# package's drift on the CPU).
ZOO_MODELS = (
    ("breast-tumor-vgg16mod.tcga-brca", "vgg16mod", 224, True, False),
    ("breast-tumor-inception_v4.tcga-brca", "inception_v4", 299, True, True),
    ("pancancer-lymphocytes-inceptionv4.tcga", "inception_v4nobn", 100, False, True),
)
ZOO_BATCHES = 10


def run_window(engine, data) -> tuple[np.ndarray, float]:
    """Batches through put -> dispatch with run_inference's two-deep window:
    (probabilities, seconds on the host clock)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending, outs = deque(), []
    for images in data:
        pending.append(engine.dispatch(engine.put(images)))
        if len(pending) > 2:
            outs.append(pending.popleft().cpu().numpy())
    outs += [p.cpu().numpy() for p in pending]
    return np.concatenate(outs), time.perf_counter() - t0


def conv_probe() -> list:
    """InceptionB's asymmetric convolutions alone, B=256 at 17 x 17,
    channels_last, beside a 3x3 of the same channels: device us per call
    (CUDA events) and TFLOP/s, in float32 with TF32 off (parity) and in
    bf16."""
    import torch

    from wsinsight_tpu_torch.engine.runner import tf32_flags

    out = []
    dev = torch.device("cuda", 0)
    for k, pad, cin, cout in (((1, 7), (0, 3), 192, 224), ((7, 1), (3, 0), 224, 256),
                              ((3, 3), (1, 1), 192, 224)):
        conv = torch.nn.Conv2d(cin, cout, k, padding=pad, bias=False).to(
            dev, memory_format=torch.channels_last)
        x = torch.randn((BATCH, cin, 17, 17), device=dev).contiguous(
            memory_format=torch.channels_last)
        flops = 2 * BATCH * 17 * 17 * cout * cin * k[0] * k[1]
        for dt in (torch.float32, torch.bfloat16):
            c, xi = conv.to(dt), x.to(dt)
            with torch.inference_mode(), tf32_flags(False):
                ms = _cuda_ms(lambda: c(xi), reps=20)
            out.append({"kernel": f"{k[0]}x{k[1]}", "cin": cin, "cout": cout,
                        "dtype": str(dt)[6:], "us": ms * 1e3, "tflop_s": flops / ms / 1e9})
    return out


def zoo_phase(check, kernels, card, resnet) -> dict:
    """(m): VGG16 (vgg16mod), InceptionV4 and InceptionV4 without batch norm
    (the lymphocyte model) through ClassifierEngine in parity and bf16, then
    WSINSIGHT_PRECISION on (d)'s ResNet34 batches. ``resnet`` is (d)'s
    (handle, batches, parity engine, parity probabilities). Its patches come
    from a generator of its own, so the later phases' seeded inputs are
    those of the runs before it."""
    import torch

    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.zoo import ModelHandle, get_registered_model, make_random_local_model

    rng = np.random.default_rng(SEED + 1)
    stats = {}
    t_m = time.perf_counter()
    for name, arch, resize, fused, bf16_checked in ZOO_MODELS:
        cfg = get_registered_model(name).config
        ps = cfg.patch_size_pixels
        tmp = tempfile.TemporaryDirectory()
        t0 = time.perf_counter()
        _, weights = make_random_local_model(arch, cfg.num_classes, tmp.name, resize_size=resize,
                                             seed=SEED)
        handle = ModelHandle(name=name, config=cfg, weights_path=str(weights))
        data = rng.integers(0, 256, (ZOO_BATCHES, BATCH, ps, ps, 3), dtype=np.uint8)
        engines = {m: ClassifierEngine(handle, mixed_precision=m) for m in (False, True)}
        n_params = sum(p.numel() for p in engines[False].model.parameters())
        print(f"(m) {name} ({arch}, {n_params / 1e6:.1f} M parameters, seeded): {ZOO_BATCHES}"
              f" batches of B={BATCH} seeded {ps} px patches, resize {resize}; weights, data and"
              f" engines in {time.perf_counter() - t0:.1f} s; {card}")
        for engine in engines.values():  # warm-up: cuDNN plans, pinned buffers
            engine.run_batch(data[0], BATCH)
        probs, model_stats = {}, {}
        for mixed, engine in engines.items():
            mode = "bf16" if mixed else "parity"
            torch.cuda.reset_peak_memory_stats()
            for fn in kernels:
                fn.launches = 0
            probs[mode], secs = run_window(engine, data)
            launches = {kname: fn.launches for fn, kname in kernels.items()}
            x = engine.put(data[1])
            step = _cuda_ms(lambda: engine.dispatch(x), reps=5)
            pre = _cuda_ms(lambda: engine._preprocess(x[0]), reps=5)
            st = model_stats[mode] = {
                "patches_s": ZOO_BATCHES * BATCH / secs,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "step_ms": step, "preprocess_ms": pre, "launches": launches}
            print(f"    {mode}: {st['patches_s']:.1f} patches/s, peak {st['peak_gib']:.2f} GiB;"
                  f" device per batch: whole step {step:.2f} ms, preprocess {pre:.2f} ms;"
                  f" K1 launches {launches['fused_preprocess']}")
            want = ZOO_BATCHES if (mixed and fused) else 0
            check(launches["fused_preprocess"] == want and launches["window_attention"] == 0,
                  f"(m) {name} {mode}: K1 launches {launches['fused_preprocess']} ({want}), K2"
                  f" {launches['window_attention']} (0)")
            p = probs[mode]
            dsum = float(np.abs(p.sum(axis=1) - 1.0).max())
            check(p.shape == (ZOO_BATCHES * BATCH, 2) and bool(np.isfinite(p).all())
                  and dsum <= 1e-5, f"(m) {name} {mode}: {p.shape} finite, rows sum to 1 within"
                  f" {dsum:.3g}, probabilities in [{p.min():.3f}, {p.max():.3f}]")
            del x
        x = engines[False].put(data[1])
        for mixed, engine in engines.items():
            split = top_kernels(lambda: engine.dispatch(x))
            model_stats["bf16" if mixed else "parity"]["top_kernels"] = split
            print(f"    {'bf16' if mixed else 'parity'} step's top kernels (profiler, share of"
                  " kernel time): " + "; ".join(f"{k} {v:.1%}" for k, v, _ in split))
        del x
        if arch == "inception_v4":
            probe = model_stats["conv_probe"] = conv_probe()
            print("    InceptionB's convolutions alone, B=256 at 17x17, channels_last: " + "; ".join(
                f"{c['kernel']} {c['cin']}->{c['cout']} {c['dtype']} {c['us']:.1f} us"
                f" ({c['tflop_s']:.1f} TFLOP/s)" for c in probe) + f"; {card}")
        cpu = ClassifierEngine(handle, device="cpu").run_batch(data[0, :8], 8)
        err = float(np.abs(probs["parity"][:8] - cpu).max())
        check(err <= 1e-3, f"(m) {name} parity on the card vs the CPU, 8 patches: max |dp|"
              f" {err:.3g} (<= 1e-3)")
        d = np.abs(probs["bf16"] - probs["parity"])
        agree = float((probs["bf16"].argmax(1) == probs["parity"].argmax(1)).mean())
        model_stats["bf16_vs_parity"] = {"max": float(d.max()), "mean": float(d.mean()),
                                         "p99": float(np.quantile(d, 0.99)),
                                         "argmax_agree": agree}
        what = (f"(m) {name} bf16 vs parity, {len(d)} patches: max |dp| {d.max():.3g}, mean"
                f" {d.mean():.3g}, 99th percentile {np.quantile(d, 0.99):.3g}, argmax agrees on"
                f" {agree:.2%}")
        if bf16_checked:
            check(float(d.max()) <= 0.01, what + " (max <= 0.01)")
        else:
            print(f"    {what} (reported, not checked: the JAX package's bf16 drifts as far on"
                  " these seeded weights)")
        model_stats["card_vs_cpu"] = err
        stats[name] = model_stats
        del data, engines
        torch.cuda.empty_cache()
        tmp.cleanup()

    # WSINSIGHT_PRECISION on (d)'s ResNet34 batches, against (d)'s parity run.
    handle, data, parity, parity_probs = resnet
    saved = os.environ.get("WSINSIGHT_PRECISION")
    try:
        for value in ("high", "default"):
            os.environ["WSINSIGHT_PRECISION"] = value
            engine = ClassifierEngine(handle)
            engine.run_batch(data[0], BATCH)  # warm-up
            p, secs = run_window(engine, data)
            d = float(np.abs(p - parity_probs).max())
            rate = len(data) * BATCH / secs
            stats[f"precision_{value}"] = {"patches_s": rate, "max_abs_dp": d}
            if value == "high":
                check(np.array_equal(p, parity_probs), f"(m) WSINSIGHT_PRECISION=high, ResNet34,"
                      f" {len(p)} patches: parity's probabilities bit for bit (max |dp| {d:.3g});"
                      f" {rate:.1f} patches/s")
            else:
                check(d <= 0.01, f"(m) WSINSIGHT_PRECISION=default (TF32), ResNet34, {len(p)}"
                      f" patches: max |dp| {d:.3g} against parity (<= 0.01); {rate:.1f} patches/s")
            del engine
    finally:
        if saved is None:
            os.environ.pop("WSINSIGHT_PRECISION", None)
        else:
            os.environ["WSINSIGHT_PRECISION"] = saved
    print(f"    (m) took {time.perf_counter() - t_m:.1f} s;"
          f" {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")
    return stats


def exports_phase(check, kernels, card, path, plan, workers, out_dir) -> dict:
    """(n): (j)'s slide and plan through breast-tumor-inception_v4.tcga-brca in
    bf16 (seeded weights): classify_slide -> the CSV -> write_geojsons (tiles)
    and write_omecsvs, as `infer --geojson --omecsv` runs them."""
    import gzip

    import pandas as pd
    import torch

    from wsinsight_tpu_torch.cli._options import compute_overlap
    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.engine.runner import write_slide_csv
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.writers import write_geojsons, write_omecsvs
    from wsinsight_tpu_torch.zoo import ModelHandle, get_registered_model, make_random_local_model

    name = "breast-tumor-inception_v4.tcga-brca"
    cfg = get_registered_model(name).config
    n, ps = len(plan.coords), plan.patch_size
    n_batches = -(-n // BATCH)
    tmp = tempfile.TemporaryDirectory()
    _, weights = make_random_local_model("inception_v4", cfg.num_classes, tmp.name,
                                         resize_size=299, seed=SEED)
    engine = ClassifierEngine(ModelHandle(name=name, config=cfg, weights_path=str(weights)),
                              mixed_precision=True)
    engine.run_batch(np.zeros((BATCH, ps, ps, 3), np.uint8), BATCH)  # warm-up
    print(f"(n) (j)'s slide ({n} patches of {ps} px, {n_batches} batches) through {name} in"
          f" bf16 (seeded), then the GeoJSON and OME-CSV exports; {card}")
    coords, probs, st = run_slide(engine, kernels, path, plan.coords, ps, workers)
    print(f"    bf16 end to end: {st['patches_s']:.1f} patches/s over the slide"
          f" ({st['wall_s']:.2f} s), device busy {st['busy']:.1%} of the wall time, peak"
          f" {st['peak_gib']:.2f} GiB; {card}")
    check(st["launches"]["fused_preprocess"] == n_batches,
          f"(n) K1 launches {st['launches']['fused_preprocess']} (batches: {n_batches})")
    results = URIPath(out_dir) / "exports"
    (results / "model-outputs-csv").mkdir(parents=True, exist_ok=True)
    csv = results / "model-outputs-csv" / "slide.csv"
    write_slide_csv(csv, coords, probs, cfg.class_names)
    # the CLI's overlap for a classifier with its default options
    overlap = compute_overlap(cfg, 0.0, 0.0, 0, object_based=False)
    timings = {}
    t0 = time.perf_counter()
    write_geojsons(csvs=[csv], overlap=overlap, results_dir=results,
                   output_dir="model-outputs-geojson", prefix="prob", num_workers=1,
                   object_type="tile", set_classification=False, show_progress=False)
    timings["geojson_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_omecsvs(csvs=[csv], h5s=[], overlap=overlap, results_dir=results,
                  output_dir="model-outputs-omecsv", prefix="prob", num_workers=1,
                  show_progress=False)
    timings["omecsv_s"] = time.perf_counter() - t0
    gj_path = f"{results}/model-outputs-geojson/slide.geojson"
    om_path = f"{results}/model-outputs-omecsv/slide.ome.csv.gz"
    timings.update(geojson_bytes=os.path.getsize(gj_path), omecsv_bytes=os.path.getsize(om_path))
    print(f"    write_geojsons {timings['geojson_s']:.2f} s, {timings['geojson_bytes'] / 1e6:.1f} MB;"
          f" write_omecsvs {timings['omecsv_s']:.2f} s, {timings['omecsv_bytes'] / 1e6:.2f} MB"
          " (gzip); one CSV, inline (one worker)")
    df = pd.read_csv(str(csv))
    prob_cols = [f"prob_{c}" for c in cfg.class_names]
    with open(gj_path) as fh:
        feats = json.load(fh)["features"]
    check(len(feats) == len(df) == n, f"(n) the GeoJSON parses: {len(feats)} features, one per"
          f" CSV row ({len(df)}; plan {n})")
    meas = np.float32([[f["properties"]["measurements"][c] for c in prob_cols] for f in feats])
    check(np.array_equal(meas, df[prob_cols].to_numpy(np.float32))
          and all(f["properties"]["objectType"] == "tile" for f in feats),
          "(n) each feature's measurements equal its CSV row's prob_* (float32), objectType tile")
    box = df[["minx", "miny", "width", "height"]].to_numpy(np.int64)
    kept = np.rint(box[:, 2:] * (1.0 - overlap)).astype(np.int64)
    lo = box[:, :2] + np.rint((box[:, 2:] - kept) * 0.5).astype(np.int64)
    rings = np.asarray([f["geometry"]["coordinates"][0] for f in feats])
    check(rings.shape == (n, 5, 2) and np.array_equal(rings.min(1), lo)
          and np.array_equal(rings.max(1), lo + kept),
          f"(n) each box is its CSV box shrunk by the CLI's overlap ({overlap})")
    with gzip.open(om_path, "rt") as fh:
        lines = fh.read().split("\n")
    header = ",".join(["object", "secondary_object", "polygon", "objectType", "classification",
                       *prob_cols])
    check(lines[0] == header and len(lines) == 1 + len(df),
          f"(n) the OME-CSV (gzip): {len(lines) - 1} data rows under {lines[0]}")
    d = np.abs(probs.sum(axis=1) - 1.0).max()
    check(bool(np.isfinite(probs).all()) and d <= 1e-5, f"(n) rows finite, sum to 1 within {d:.3g}")
    del engine
    torch.cuda.empty_cache()
    tmp.cleanup()
    st.update(timings)
    return {"stats": st, "k1_launches": st["launches"]["fused_preprocess"]}


# (o): HoVer-Net fast as the registry holds it (256 px, halo 46, ToTensor
# alone: the torch preprocess, no K1; all convolutions: no K2), with seeded
# weights (randomize_cell_model, seed SEED).
HOVERNET_MODEL = "hovernet_fast_pannuke"
# (p): StarDist over (l)'s slide, then an object-based classifier on its
# nuclei: the lymphocyte model's config (100 px at 0.5 um/px, Scale: the
# torch preprocess, no K1) made object-based with StarDist pre-detection.
STARDIST_CLASSIFIER = "pancancer-lymphocytes-inceptionv4.tcga"
STARDIST_BLOCK = 4096 + 128  # the first block's tile: block_size + context
STARDIST_RAY = 12.0  # px: the drawn nuclei's mean radius (NUCLEUS_RADII)
STARDIST_TILE = 512  # the card vs CPU forward check's tile side
# Paths that launch neither kernel, checked in (o) and (p): the record says so.
NO_KERNEL_PATHS = ("(o) HoVer-Net: ToTensor takes the torch preprocess, no attention",
                   "(p) StarDist: convolutions only; the lymphocyte classifier's Scale takes"
                   " the torch preprocess")


def top_kernels(fn, top: int | None = 4) -> list:
    """The ``top`` kernels (None: all) of one call of ``fn`` by device time,
    from a profiler trace: [(name, share of the call's kernel time, us)]. A
    report, not a check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
                times[evt.key] = times.get(evt.key, 0.0) + t
        total = sum(times.values()) or float("nan")
        ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
        return [(k[:70], t / total, t) for k, t in ranked]
    except Exception as err:  # the trace is a report, not a check
        print(f"    profiler trace failed: {err!r}")
        return []


def layout_kernels(kernels: list) -> list:
    """cuDNN's NHWC <-> NCHW conversions among a trace's kernels."""
    return [(k, share) for k, share, _ in kernels
            if any(w in k.lower() for w in ("nchwtonhwc", "nhwctonchw", "transpose"))]


def stride2_probe(model) -> list:
    """d1-d3's first 3x3 stride-2 conv alone at its B=CELL_BATCH input,
    channels_last, f32 with TF32 off and bf16: device us (CUDA events) of
    the TF-SAME F.pad (0, 1) alone, of the convolution alone on the padded
    map, and of the two as the model runs them."""
    import torch
    import torch.nn.functional as F

    from wsinsight_tpu_torch.engine.runner import tf32_flags

    out = []
    dev = torch.device("cuda", 0)
    for i, (ch, hw) in enumerate(((128, 256), (256, 128), (512, 64)), start=1):
        conv = getattr(model, f"d{i}").units[0].conv2
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((CELL_BATCH, ch, hw, hw), device=dev, dtype=dt).contiguous(
                memory_format=torch.channels_last)
            w = conv.weight.to(dt)
            xp = F.pad(x, conv._side_pad)
            with torch.inference_mode(), tf32_flags(False):
                pad = _cuda_ms(lambda: F.pad(x, conv._side_pad), reps=10) * 1e3
                alone = _cuda_ms(lambda: F.conv2d(xp, w, None, 2), reps=10) * 1e3
                both = _cuda_ms(lambda: F.conv2d(F.pad(x, conv._side_pad), w, None, 2),
                                reps=10) * 1e3
            out.append({"conv": f"d{i}.units.0.conv2", "in": [CELL_BATCH, ch, hw, hw],
                        "dtype": str(dt)[6:], "pad_us": pad, "conv_us": alone, "both_us": both,
                        "padded_channels_last": xp.is_contiguous(
                            memory_format=torch.channels_last)})
            del x, w, xp
    return out


def hovernet_window(path, nuclei, ps: int, halo: int):
    """(o)'s resident batches: the CELL_GRID x CELL_GRID halo grid of ps px
    patches over the window of (l)'s slide (on a 512 px grid) that holds the
    most drawn nuclei, as (CELL_BATCHES, CELL_BATCH, ps, ps, 3) uint8 in
    canvas order; the drawn nuclei's mask over the patches' interiors (the
    canvas); the window's origin."""
    import cv2

    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.wsi import get_wsi_cls

    out_px = ps - 2 * halo
    side = CELL_GRID * out_px
    span = side + 2 * halo
    centres, radii, angles = nuclei
    starts = range(0, CELL_SLIDE_PX - span + 1, 512)
    x0, y0 = max(((x, y) for y in starts for x in starts), key=lambda o: int(
        ((centres >= o) & (centres < (o[0] + span, o[1] + span))).all(axis=1).sum()))
    slide = get_wsi_cls()(URIPath(path))
    try:
        region = slide.read_region_array((x0, y0), 0, (span, span))
    finally:
        slide.close()
    mask = np.zeros((span, span), np.uint8)
    for (x, y), (rx, ry), a in zip(centres, radii, angles):
        cv2.ellipse(mask, (int(x) - x0, int(y) - y0), (int(rx), int(ry)), float(a), 0, 360, 1, -1)
    idx = np.arange(CELL_GRID * CELL_GRID)
    data = np.stack([region[r:r + ps, c:c + ps] for r, c in zip(idx // CELL_GRID * out_px,
                                                                idx % CELL_GRID * out_px)])
    return (data.reshape(CELL_BATCHES, CELL_BATCH, ps, ps, 3),
            mask[halo:halo + side, halo:halo + side] > 0, (x0, y0))


def hovernet_np_head(engines, images, mask) -> dict:
    """Set the NP head of ``engines``' HoVer-Nets (one seeded model: parity
    and bf16 on the card, then any others) from a probe of ``images`` through
    the first two, as (p) sets StarDist's prob head: the foreground logit is
    the head's input features projected on their mean inside the drawn
    nuclei (``mask``, over the outputs) less their mean outside, scaled to a
    spread of 4, less the projection's quantile at the drawn nuclei's share
    of the probe; the background logit is 0. The seeded head puts the
    foreground wherever its weights do (on (l)'s slide: nowhere), so NP's
    decisions would not be compared. Returns what was chosen and, as a
    report, the seeded head's bf16-vs-parity flip share on the probe, its
    logits cut at the same foreground share."""
    import torch

    feats, logits = [], []
    for engine in engines[:2]:
        got = []
        conv = engine.model.decoder.np.u0.conv
        hook = conv.register_forward_hook(lambda m, i, o: got.append(i[0].float()))
        try:
            out = engine.run_batch(images)["nuclei_binary_map"].float()
        finally:
            hook.remove()
        feats.append(got[0])
        logits.append((out[:, 1] - out[:, 0]).cpu().numpy())
    share = float(mask.mean())
    cut = np.quantile(logits[0], 1 - share)
    seeded_flip = float(np.mean((logits[0] > cut) != (logits[1] > cut)))
    f = feats[0].permute(0, 2, 3, 1)  # (B, H, W, 64)
    inside = torch.from_numpy(mask).to(f.device)
    with torch.inference_mode():
        w = f[inside].mean(0) - f[~inside].mean(0)
        proj = (f @ w).cpu().numpy()
    scale = 4.0 / float(proj.std())
    thr = float(np.quantile(proj, 1 - share))
    with torch.no_grad():
        for engine in engines:
            conv = engine.model.decoder.np.u0.conv
            conv.weight.zero_()
            conv.weight[1, :, 0, 0] = (w * scale).to(conv.weight.device)
            conv.bias.zero_()
            conv.bias[1] = -thr * scale
    return {"foreground_share": share, "logit_scale": scale,
            "seeded_head_bf16_flip": seeded_flip,
            "agrees_with_drawn_on_probe": float(np.mean((proj > thr) == mask))}


def hovernet_phase(check, kernels, card, cell_slide) -> dict:
    """(o): HoVer-Net fast through CellEngine in parity and bf16 on resident
    batches (as (g), cut from (l)'s slide), its results against the CPU and
    between the modes, then (l)'s slide through the halo grid -> stitch_slide
    -> finalize -> the CSV in bf16."""
    import pandas as pd
    import torch

    from wsinsight_tpu_torch.cli.infer import default_infer_workers, default_stitch_workers
    from wsinsight_tpu_torch.engine import CellEngine, TileRemapStitcher
    from wsinsight_tpu_torch.engine.runner import write_slide_csv
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils.workers import governed_workers
    from wsinsight_tpu_torch.zoo import get_registered_model

    t_o = time.perf_counter()
    path, _, nuclei, _ = cell_slide
    handle = get_registered_model(HOVERNET_MODEL)
    cfg = handle.config
    ps, halo = cfg.patch_size_pixels, cfg.halo_size_pixels
    out_px = ps - 2 * halo
    side = CELL_GRID * out_px
    data, drawn, origin = hovernet_window(path, nuclei, ps, halo)
    idx = np.arange(CELL_BATCHES * CELL_BATCH).reshape(CELL_BATCHES, CELL_BATCH)
    xy = np.stack([idx % CELL_GRID * out_px - halo, idx // CELL_GRID * out_px - halo,
                   np.full_like(idx, ps), np.full_like(idx, ps)], axis=-1)
    t0 = time.perf_counter()
    engines = {m: CellEngine(handle, mixed_precision=m, init_random=True, seed=SEED)
               for m in (False, True)}
    cpu_engine = CellEngine(handle, init_random=True, seed=SEED, device="cpu")
    n_params = sum(p.numel() for p in engines[False].model.parameters())
    print(f"(o) {HOVERNET_MODEL} (HoVer-Net fast, {n_params / 1e6:.2f} M parameters, seeded;"
          f" {ps} px, halo {halo}, transform {[t.name for t in cfg.transform]}):"
          f" {CELL_BATCHES} batches of B={CELL_BATCH} patches of (l)'s slide at {origin} (drawn"
          f" nuclei on {drawn.mean():.2%} of the canvas) into a {side}^2 canvas; three engines"
          f" built in {time.perf_counter() - t0:.1f} s; {card}")
    # the probe: every 8th patch, spread over the window
    probe = data.reshape(-1, ps, ps, 3)[::CELL_BATCHES]
    probe_mask = drawn.reshape(CELL_GRID, out_px, CELL_GRID, out_px).transpose(0, 2, 1, 3)
    probe_mask = np.ascontiguousarray(probe_mask.reshape(-1, out_px, out_px)[::CELL_BATCHES])
    head = hovernet_np_head([engines[False], engines[True], cpu_engine], probe, probe_mask)
    print(f"    NP head set from a probe of {len(probe)} patches: {head}")
    stitchers, stats = {}, {"parameters": n_params, "window": list(origin), "np_head": head}
    for mixed, engine in engines.items():
        mode = "bf16" if mixed else "parity"
        warm = TileRemapStitcher(cfg.num_classes, side, side, out_px, halo, 0.25,
                                 cfg.spacing_um_px)
        run_cells(engine, warm, data[:1], xy[:1])  # warm-up: cuDNN plans, pinned buffers
        st = TileRemapStitcher(cfg.num_classes, side, side, out_px, halo, 0.25,
                               cfg.spacing_um_px)
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        secs = run_cells(engine, st, data, xy)
        counts = {name: fn.launches for fn, name in kernels.items()}
        stitchers[mode] = st
        x = engine.put(data[1])
        pred = engine.dispatch(x)
        fwd = _cuda_ms(lambda: engine.dispatch(x), reps=3)
        post = _cuda_ms(lambda: st.device_postprocess(pred), reps=10)
        every = top_kernels(lambda: engine.dispatch(x), top=None)
        top, layout = every[:4], layout_kernels(every)
        stats[mode] = {"patches_s": CELL_BATCHES * CELL_BATCH / secs,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "forward_ms": fwd, "post_ms": post, "launches": counts,
                       "top_kernels": top, "kernels_in_trace": len(every),
                       "layout_kernels": layout}
        print(f"    {mode}: {stats[mode]['patches_s']:.1f} patches/s resident, peak"
              f" {stats[mode]['peak_gib']:.2f} GiB; device per batch: forward {fwd:.2f} ms"
              f" ({CELL_BATCH / fwd * 1e3:.1f} patches/s), post-process {post:.2f} ms; {card}")
        print(f"    {mode} forward's top kernels (profiler, share of kernel time): "
              + "; ".join(f"{k} {v:.1%}" for k, v, _ in top))
        print(f"    {mode} forward's layout conversions among its {len(every)} kernels: "
              + ("; ".join(f"{k} {v:.1%}" for k, v in layout) or "none"))
        check(counts == {"fused_preprocess": 0, "window_attention": 0},
              f"(o) {mode}: K1 and K2 launches over HoVer-Net {counts} (0: ToTensor takes the"
              " torch preprocess, and the model has no attention)")
        del x, pred
    probe = stats["stride2"] = stride2_probe(engines[False].model)
    for c in probe:
        print(f"    {c['conv']} alone, in {c['in']} channels_last, {c['dtype']}: the TF-SAME"
              f" F.pad {c['pad_us']:.1f} us (its output channels_last:"
              f" {c['padded_channels_last']}), the convolution on the padded map"
              f" {c['conv_us']:.1f} us, both {c['both_us']:.1f} us")
    print(f"    {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")

    on_card = engines[False].run_batch(data[0, :2])
    on_host = cpu_engine.run_batch(data[0, :2])
    err = max(float((on_card[k].cpu() - on_host[k]).abs().max())
              for k in ("nuclei_binary_map", "hv_map", "nuclei_type_map"))
    stats["card_vs_cpu"] = err
    check(err <= 1e-3, f"(o) parity on the card vs the CPU, 2 patches: max |d| of the maps"
          f" {err:.3g} (<= 1e-3)")
    p32, p16 = stitchers["parity"], stitchers["bf16"]
    fg32, fg16 = p32.np_map > 0.5, p16.np_map > 0.5
    np_flip = float(np.mean(fg16 != fg32))
    d_np = float(np.abs(p16.np_map - p32.np_map).max())
    stats["foreground"] = {"parity": float(fg32.mean()), "bf16": float(fg16.mean()),
                           "drawn": float(drawn.mean()),
                           "agrees_with_drawn": float(np.mean(fg32 == drawn))}
    stats["bf16_np_flip"] = np_flip
    check(0.05 <= fg32.mean() <= 0.95,
          f"(o) parity's NP > 0.5 on {fg32.mean():.2%} of the canvas (5-95%: decisions to"
          f" compare; the drawn nuclei cover {drawn.mean():.2%}, the map agrees with them on"
          f" {stats['foreground']['agrees_with_drawn']:.2%})")
    check(np_flip <= 0.01, f"(o) bf16 vs parity over {side}x{side} px: NP > 0.5 differs on"
          f" {np_flip:.3%} (<= 1%); max |d| NP {d_np:.3g}")
    for mode, st in (("parity", p32), ("bf16", p16)):
        ok = all(bool(np.isfinite(m).all()) for m in (st.np_map, st.hv_map, st.tp_map))
        tp_sum = float(np.abs(st.tp_map.sum(-1) - 1.0).max())
        check(ok and tp_sum <= cfg.num_classes * 0.5 / 255 + 1e-6,
              f"(o) {mode} canvas finite, TP rows sum to 1 within {tp_sum:.3g} (quantized"
              " transfer, <= K/2 levels)")
    engine = engines[True]
    del engines, cpu_engine, stitchers, p32, p16, fg32, fg16, on_card, on_host, st
    torch.cuda.empty_cache()

    # (l)'s slide through the halo grid, in bf16, with the HV head zeroed as
    # the CPU tests' end-to-end runs do: seeded HV fields leave the watershed
    # no seeds, a zero field leaves each NP component one instance
    with torch.no_grad():
        engine.model.decoder.hv.u0.conv.weight.zero_()
        engine.model.decoder.hv.u0.conv.bias.zero_()
    t0 = time.perf_counter()
    plan, ctx, *_ = plan_slide(URIPath(path), None, None, None, ps, cfg.spacing_um_px, halo,
                               object_based=True, object_detection="end2end")
    plan_s = time.perf_counter() - t0
    dims = ctx.slide.dimensions
    ctx.slide.close()
    n = len(plan.coords)
    n_batches = -(-n // CELL_BATCH)
    workers = governed_workers(default_infer_workers())
    stitch_workers = default_stitch_workers()
    st, out, run = run_cell_slide(engine, kernels, path, plan.coords, plan.patch_size, dims,
                                  workers, stitch_workers)
    stats["slide"] = run
    stats["slide"]["plan_s"] = plan_s
    host = run["host_shares"]
    print(f"    (l)'s slide, bf16: halo grid {n} patches ({n_batches} batches, plan {plan_s:.2f}"
          f" s); {run['patches_s']:.1f} patches/s without the finalize ({run['wall_s']:.2f} s),"
          f" {run['patches_s_with_finalize']:.1f} with it; device busy {run['busy']:.1%}; peak"
          f" {run['peak_gib']:.2f} GiB; finalize {run['finalize_s']:.2f} s on"
          f" {stitch_workers} worker(s), {run['tiles']} tiles; foreground"
          f" {run['foreground']:.2%}, {run['instances']} instances ({len(nuclei[0])} nuclei"
          f" drawn); {card}")
    print(f"    main thread, share of the wall time: waiting for decoded batches"
          f" {host['decode_wait']:.1%}, put {host['put']:.1%}, dispatch {host['dispatch']:.1%},"
          f" scatter {host['scatter']:.1%}, the rest {1 - sum(host.values()):.1%}")
    check(run["batches"] == n_batches and run["launches"] == {"fused_preprocess": 0,
                                                                "window_attention": 0},
          f"(o) slide: {run['batches']} batches, K1 and K2 launches {run['launches']} (0)")
    boxes, probs, polys = out
    inside = all(len(r) >= 3 and (r.min(0) >= b[0, :2]).all()
                 and (r.max(0) <= b[0, :2] + b[0, 2:] - 1).all() for b, r in zip(boxes, polys))
    check(0 < len(boxes) == len(probs) == len(polys) and inside,
          f"(o) slide: boxes, probabilities and polygons aligned ({len(boxes)} instances, > 0),"
          " every polygon inside its bbox")
    tmp = tempfile.TemporaryDirectory()
    csv = URIPath(f"{tmp.name}/hovernet.csv")
    k = cfg.num_classes
    write_slide_csv(csv, np.concatenate(boxes) if boxes else np.zeros((0, 4), np.int32),
                    np.concatenate(probs) if probs else np.zeros((0, k), np.float32),
                    cfg.class_names)
    df = pd.read_csv(str(csv))
    p = df[[f"prob_{c}" for c in cfg.class_names]].to_numpy(np.float64)
    dsum = float(np.abs(p.sum(axis=1) - 1.0).max()) if len(p) else 0.0
    check(0 < len(df) == len(boxes) and bool(np.isfinite(p).all())
          and dsum <= k * 0.5 / 255 + 1e-6,
          f"(o) slide: the CSV has one row per instance ({len(df)}), rows finite, summing to 1"
          f" within {dsum:.3g}")
    st.close()
    tmp.cleanup()
    del engine
    torch.cuda.empty_cache()
    print(f"    (o) took {time.perf_counter() - t_o:.1f} s;"
          f" {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")
    return stats


def drawn_stardist_maps(nuclei, side: int):
    """The prob and dist maps a perfect StarDist gives for the drawn nuclei,
    on its grid (side / GRID): prob 1 - the elliptic radius of the pixel in
    its nucleus (1 at the centre, 0 at the edge; the last drawn of two
    overlapping nuclei owns their overlap, 0 outside), dist the 32 rays'
    exact lengths to that nucleus's edge, in full-resolution px."""
    import cv2

    from wsinsight_tpu_torch.models.stardist import GRID, N_RAYS

    centres, radii, angles = nuclei
    g = side // GRID
    owner = np.zeros((g, g), np.int32)
    for i, ((x, y), (rx, ry), a) in enumerate(zip(centres, radii, angles), start=1):
        cv2.ellipse(owner, (int(x) // GRID, int(y) // GRID), (int(rx) // GRID + 1,
                    int(ry) // GRID + 1), float(a), 0, 360, i, -1)
    ys, xs = np.nonzero(owner)
    k = owner[ys, xs] - 1
    theta = np.deg2rad(angles[k]).astype(np.float32)
    a, b = radii[k, 0].astype(np.float32), radii[k, 1].astype(np.float32)
    dx = (xs * GRID - centres[k, 0]).astype(np.float32)
    dy = (ys * GRID - centres[k, 1]).astype(np.float32)
    u = dx * np.cos(theta) + dy * np.sin(theta)
    v = -dx * np.sin(theta) + dy * np.cos(theta)
    rho2 = (u / a) ** 2 + (v / b) ** 2
    inside = rho2 < 1
    ys, xs, theta, a, b, u, v, rho2 = (t[inside] for t in (ys, xs, theta, a, b, u, v, rho2))
    prob = np.zeros((g, g), np.float32)
    prob[ys, xs] = 1 - np.sqrt(rho2)
    phis = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False, dtype=np.float32)
    eu = np.cos(phis[None] - theta[:, None])  # the ray in the ellipse's frame
    ev = np.sin(phis[None] - theta[:, None])
    qa = (eu / a[:, None]) ** 2 + (ev / b[:, None]) ** 2
    qb = 2 * (u[:, None] * eu / a[:, None] ** 2 + v[:, None] * ev / b[:, None] ** 2)
    qc = (rho2 - 1)[:, None]
    dist = np.zeros((g, g, N_RAYS), np.float32)
    dist[ys, xs] = (-qb + np.sqrt(qb * qb - 4 * qa * qc)) / (2 * qa)
    return prob, dist


def stardist_weights(path, drawn_prob, nuclei) -> tuple[dict, dict, np.ndarray]:
    """Seeded StarDistUNet weights whose heads see (l)'s drawn nuclei: the
    U-Net seeded (conv weights normal with variance 2/fan-in, biases
    N(0, 0.1^2)); then, from a probe of the first block (its tile, 4224 px
    square, normalized by the slide's percentiles), the prob head's weights
    are the features' mean inside the drawn nuclei's inner halves less their
    mean outside any nucleus, and its bias the threshold (0.5x, 0.75x, 1x or
    1.5x the inner halves' pixel count above 0.5) whose NMS keeps the count
    nearest the block's drawn nuclei; the dist head gives rays of
    STARDIST_RAY px with a seeded spread of 1.5 px. Returns (the port's state
    dict, what was chosen, the probe's normalized tile)."""
    import torch

    from wsinsight_tpu_torch.models import stardist as sd
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.wsi import get_wsi_cls

    gen = torch.Generator().manual_seed(SEED)
    model = sd.StarDistUNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
    slide = get_wsi_cls()(URIPath(path))
    try:
        level0 = slide.read_region_array((0, 0), 0, slide.dimensions)
    finally:
        slide.close()
    # the plan's normalization: the whole image's percentiles (here of every
    # 4th pixel of each 4th row)
    lo, hi = (float(v) for v in np.percentile(level0[::4, ::4].astype(np.float32), (1.0, 99.8)))
    tile = (level0[:STARDIST_BLOCK, :STARDIST_BLOCK].astype(np.float32) - lo) / max(hi - lo, 1e-20)
    del level0
    g = STARDIST_BLOCK // sd.GRID
    drawn = drawn_prob[:g, :g]
    dev = torch.device("cuda", 0)
    net = sd.StarDist2D(model.state_dict(), device=dev)
    feats = []
    hook = net.model.prob.register_forward_hook(lambda m, i, o: feats.append(i[0]))
    from wsinsight_tpu_torch.engine.runner import tf32_flags

    with torch.inference_mode(), tf32_flags(False):
        net.model(torch.from_numpy(tile[None]).to(dev))
        hook.remove()
        f = feats[0][0]  # (128, g, g)
        pos = torch.from_numpy(drawn > 0.5).to(dev)
        neg = torch.from_numpy(drawn == 0).to(dev)
        # the mean difference: Fisher's discriminant finds more of the drawn
        # nuclei but cancels ten times more in w.f, which the card's and the
        # CPU's roundings then move past prob's 1e-5
        w = f[:, pos].mean(1) - f[:, neg].mean(1)
        proj = torch.einsum("chw,c->hw", f, w)
        dist_w, dist_b = net.model.dist.weight[:, :, 0, 0], net.model.dist.bias
        rays = torch.einsum("chw,rc->rhw", f, dist_w) + dist_b[:, None, None]
        spread = 1.5 / float(rays.std())
        shift = STARDIST_RAY - float(rays.mean()) * spread
        flat = proj.flatten().sort(descending=True).values
    scale = 4.0 / float(proj.std())  # prob's logits of a few units: no saturation
    n_pos = int(pos.sum())
    # the block's drawn nuclei, as the plan's interior filter counts them
    centres = nuclei[0]
    in_block = int(((centres < 4096).all(axis=1)).sum())
    chosen = None
    proj_np = proj.cpu().numpy()
    rays_np = (rays.permute(1, 2, 0).cpu().numpy() * spread + shift)
    for share in (0.5, 0.75, 1.0, 1.5):
        thr = float(flat[int(share * n_pos)])
        prob = 1 / (1 + np.exp(-(proj_np - thr) * scale))
        scores, cands, r = sd._ray_candidates(prob[:2048, :2048], rays_np[:2048, :2048], 0.5)
        kept = len(sd._nms(scores, cands, r, 0.4))
        print(f"    (p) prob threshold at {share}x the inner halves' {n_pos} px: {len(scores)}"
              f" candidates, {kept} kept by the NMS in the block's interior (drawn there:"
              f" {in_block})")
        if chosen is None or abs(kept - in_block) < abs(chosen[1] - in_block):
            chosen = (share, kept, thr, len(scores))
    share, kept, thr, n_cands = chosen
    with torch.no_grad():
        net.model.prob.weight.copy_((w * scale).reshape(1, -1, 1, 1).cpu())
        net.model.prob.bias.fill_(-thr * scale)
        net.model.dist.weight.mul_(spread)
        net.model.dist.bias.mul_(spread).add_(shift)
    state = {k: v.detach().cpu() for k, v in net.model.state_dict().items()}
    what = {"threshold_share": share, "candidates_probe": n_cands, "kept_probe": kept,
            "drawn_in_block_interior": in_block, "inner_px": n_pos, "prob_scale": scale,
            "ray_mean": STARDIST_RAY, "ray_spread": 1.5}
    del net, feats, f, proj, rays
    torch.cuda.empty_cache()
    return state, what, tile


def stardist_phase(check, kernels, card, cell_slide) -> dict:
    """(p): StarDist pre-detection over (l)'s slide (plan_slide with
    object_based=True, object_detection="stardist", seeded weights read from
    a temporary WSINSIGHT_MODEL_DIR), timed by step; the NMS on the drawn
    nuclei's own maps; the forward on the card vs the CPU; then the plan's
    nuclei through the object-based lymphocyte classifier in bf16 -> the CSV
    -> write_geojsons."""
    import pandas as pd
    import torch
    from scipy.spatial import cKDTree

    from wsinsight_tpu_torch.cli._options import compute_overlap
    from wsinsight_tpu_torch.cli.infer import default_infer_workers
    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.engine.runner import write_slide_csv
    from wsinsight_tpu_torch.geometry import polygon_centroid
    from wsinsight_tpu_torch.models import stardist as sd
    from wsinsight_tpu_torch.models.convert import save_flax_msgpack
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils.profiling import hot_stage_report
    from wsinsight_tpu_torch.utils.workers import governed_workers
    from wsinsight_tpu_torch.writers import write_geojsons
    from wsinsight_tpu_torch.zoo import (
        ModelHandle,
        ObjectDetectionConfiguration,
        get_registered_model,
        make_random_local_model,
    )

    t_p = time.perf_counter()
    path, _, nuclei, _ = cell_slide
    n_drawn = len(nuclei[0])
    t0 = time.perf_counter()
    drawn_prob, drawn_dist = drawn_stardist_maps(nuclei, CELL_SLIDE_PX)
    maps_s = time.perf_counter() - t0
    print(f"(p) StarDist over (l)'s slide ({CELL_SLIDE_PX}^2 px, {n_drawn} nuclei drawn); the"
          f" drawn nuclei's own maps built in {maps_s:.1f} s; {card}")
    t0 = time.perf_counter()
    state, chosen, tile = stardist_weights(path, drawn_prob, nuclei)
    print(f"    seeded weights from a probe of the first block in {time.perf_counter() - t0:.1f}"
          f" s; chosen: {chosen}")
    stats = {"weights": chosen, "drawn": n_drawn}

    # the drawn nuclei's own maps through the candidates and the NMS
    t0 = time.perf_counter()
    scores, cands, rays = sd._ray_candidates(drawn_prob, drawn_dist, 0.5)
    kept = sd._nms(scores, cands, rays, 0.4)
    drawn_nms_s = time.perf_counter() - t0
    near, _ = cKDTree(cands[kept]).query(nuclei[0].astype(np.float64))
    found = float((near <= 2.0).mean())
    stats["drawn_nms"] = {"candidates": len(scores), "kept": len(kept), "within_2px": found,
                          "seconds": drawn_nms_s}
    print(f"    NMS on the drawn nuclei's own maps: {len(scores)} candidates -> {len(kept)} kept"
          f" of {n_drawn} drawn in {drawn_nms_s:.2f} s; {found:.2%} of the drawn nuclei have a"
          " kept centre within 2 px")
    check(0.8 * n_drawn <= len(kept) <= 1.05 * n_drawn and found >= 0.8,
          f"(p) the NMS on the drawn maps keeps {len(kept)} for {n_drawn} drawn nuclei (80-105%:"
          f" close ones suppress each other, an occluded one may split) and finds {found:.2%}"
          " of the drawn centres within 2 px (>= 80%)")
    del drawn_prob, drawn_dist, scores, cands, rays

    # the forward on the card vs the CPU, one 512 px tile of the probe block
    x0 = int(np.clip(nuclei[0][0, 0] - STARDIST_TILE // 2, 0, STARDIST_BLOCK - STARDIST_TILE))
    y0 = int(np.clip(nuclei[0][0, 1] - STARDIST_TILE // 2, 0, STARDIST_BLOCK - STARDIST_TILE))
    small = np.ascontiguousarray(tile[y0:y0 + STARDIST_TILE, x0:x0 + STARDIST_TILE])
    maps, logits = [], []
    w = state["prob.weight"].double().reshape(-1, 1, 1)
    b = float(state["prob.bias"])
    for where in ("cuda", "cpu"):
        net, got = sd.StarDist2D(state, device=where), []
        net.model.prob.register_forward_hook(lambda m, i, o: got.append(i[0][0].double().cpu()))
        maps.append(net.predict_tile(small))
        terms = got[0] * w  # (128, h, w): prob's pre-sigmoid logit is their sum plus b
        logits.append((terms.sum(0) + b, terms.abs().sum(0) + abs(b)))
    (card_p, card_d), (cpu_p, cpu_d) = maps
    dp, dd = float(np.abs(card_p - cpu_p).max()), float(np.abs(card_d - cpu_d).max())
    rel = float(((logits[0][0] - logits[1][0]).abs() / logits[1][1]).max())
    stats["card_vs_cpu"] = {"prob": dp, "dist": dd, "prob_logit_rel": rel}
    check(dp <= 1e-5 and dd <= 1e-3, f"(p) StarDist forward on the card vs the CPU, a"
          f" {STARDIST_TILE}^2 tile at ({x0}, {y0}): max |d| prob {dp:.3g} (<= 1e-5), dist"
          f" {dd:.3g} px (<= 1e-3)")
    check(rel <= 1e-4, f"(p) the same: prob's pre-sigmoid logit differs by at most {rel:.3g} of"
          " the size of its terms (sum of |w_c f_c| and |b|; <= 1e-4, whatever the head's"
          " weights)")
    del tile

    # plan_slide in StarDist mode, each step timed
    weights_dir = tempfile.TemporaryDirectory()
    params = {name: {"kernel": state[f"{name}.weight"].permute(2, 3, 1, 0).numpy(),
                     "bias": state[f"{name}.bias"].numpy()}
              for name in {k.rsplit(".", 1)[0] for k in state}}
    save_flax_msgpack(params, f"{weights_dir.name}/stardist_2D_versatile_he.msgpack")
    cls_handle = get_registered_model(STARDIST_CLASSIFIER)
    cfg = cls_handle.config
    cfg.object_based = True
    cfg.object_detection = ObjectDetectionConfiguration(name="stardist")
    forwards = []  # (tile, start, end): CUDA events around each block's U-Net forward

    def forward_start(module, args):
        if isinstance(module, sd.StarDistUNet):
            forwards.append((tuple(args[0].shape[1:3]), torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True)))
            forwards[-1][1].record()

    def forward_end(module, args, out):
        if isinstance(module, sd.StarDistUNet):
            forwards[-1][2].record()

    class Counts(logging.Handler):
        def emit(self, record):
            counts.update(getattr(record, "stardist_counts", {}))

    counts = {}
    sd_log, handler = logging.getLogger(sd.__name__), Counts()
    level = sd_log.level
    sd_log.addHandler(handler)
    sd_log.setLevel(logging.INFO)
    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(forward_start),
             torch.nn.modules.module.register_module_forward_hook(forward_end))
    saved_dir = os.environ.get("WSINSIGHT_MODEL_DIR")
    os.environ["WSINSIGHT_MODEL_DIR"] = weights_dir.name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hot_stage_report(reset=True)
    for fn in kernels:
        fn.launches = 0
    try:
        t0 = time.perf_counter()
        planned = plan_slide(URIPath(path), None, None, None, cfg.patch_size_pixels,
                             cfg.spacing_um_px, object_based=True, object_detection="stardist")
        plan_s = time.perf_counter() - t0
    finally:
        for hook in hooks:
            hook.remove()
        sd_log.removeHandler(handler)
        sd_log.setLevel(level)
        if saved_dir is None:
            os.environ.pop("WSINSIGHT_MODEL_DIR", None)
        else:
            os.environ["WSINSIGHT_MODEL_DIR"] = saved_dir
    steps = {k.split(".", 1)[1] + "_s": v for k, v in hot_stage_report().items()
             if k.startswith("stardist.")}
    plan, ctx, *_ = planned
    ctx.slide.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan_launches = {name: fn.launches for fn, name in kernels.items()}
    torch.cuda.synchronize()
    fwd_ms = [s.elapsed_time(e) for _, s, e in forwards]
    n_nuclei, n_coords = len(plan.polygons), len(plan.coords)
    stats["plan"] = {**steps, "forward_events_s": sum(fwd_ms) / 1e3, "plan_s": plan_s,
                     "tiles": [list(t) for t, _, _ in forwards], "forward_ms": fwd_ms, **counts,
                     "nuclei": n_nuclei, "coords": n_coords, "peak_gib": peak,
                     "launches": plan_launches}
    rest = plan_s - sum(steps.values())
    print(f"    plan_slide (StarDist mode) {plan_s:.2f} s, by its stages (hot_stage, host clock):"
          + ", ".join(f" {k[:-2]} {v:.3f} s" for k, v in steps.items())
          + f"; the rest (thumbnail, segmentation, rings, coords) {rest:.2f} s; the U-Net forward"
          f" per block of {[t for t, _, _ in forwards]}: {', '.join(f'{t:.1f}' for t in fwd_ms)}"
          " ms (CUDA events)")
    seen = cKDTree(np.stack([r[:-1].mean(0) for r in plan.polygons]).astype(np.float64))
    near_model = float((seen.query(nuclei[0].astype(np.float64))[0] <= 4.0).mean())
    stats["plan"]["drawn_within_4px"] = near_model
    print(f"    {counts.get('candidates')} candidates over the blocks, {counts.get('interior')} in"
          f" their interiors, {n_nuclei} nuclei kept ({n_drawn} drawn; {near_model:.1%} of those"
          f" have a kept centre within 4 px), {n_coords} coords in tissue; peak {peak:.2f} GiB on"
          f" the card; {card}")
    stages = ("read_s", "normalize_s", "copy_in_s", "forward_s", "copy_out_s", "candidates_s",
              "nms_s")
    check(all(steps.get(k, 0.0) > 0 for k in stages),
          f"(p) every stage of the plan timed: {sorted(steps)} (each > 0 s)")
    check(len(forwards) == counts.get("blocks") == 4
          and all(t == (STARDIST_BLOCK, STARDIST_BLOCK) for t, _, _ in forwards),
          f"(p) 4 blocks of {STARDIST_BLOCK}^2 px through the U-Net on the card: {len(forwards)}"
          f" forwards, {counts.get('blocks')} blocks logged")
    check(5000 <= n_nuclei <= 20000 and 0 < n_coords <= n_nuclei
          and all(len(r) == sd.N_RAYS + 1 and np.array_equal(r[0], r[-1]) for r in plan.polygons),
          f"(p) {n_nuclei} nuclei (5,000-20,000), {n_coords} in tissue, each a closed star"
          f" polygon of {sd.N_RAYS} rays")
    check(plan_launches == {"fused_preprocess": 0, "window_attention": 0},
          f"(p) K1 and K2 launches over StarDist {plan_launches} (0: convolutions only)")

    # the plan's nuclei through the object-based classifier, bf16
    tmp = tempfile.TemporaryDirectory()
    _, weights = make_random_local_model("inception_v4nobn", cfg.num_classes, tmp.name,
                                         resize_size=cfg.patch_size_pixels, seed=SEED)
    engine = ClassifierEngine(ModelHandle(name=STARDIST_CLASSIFIER, config=cfg,
                                          weights_path=str(weights)), mixed_precision=True)
    ps = plan.patch_size
    engine.run_batch(np.zeros((BATCH, ps, ps, 3), np.uint8), BATCH)  # warm-up
    workers = governed_workers(default_infer_workers())
    coords, probs, run = run_slide(engine, kernels, path, plan.coords, ps, workers)
    stats["classifier"] = run
    print(f"    {STARDIST_CLASSIFIER} (object-based, seeded, bf16) on the {n_coords} nuclei"
          f" ({ps} px patches): {run['patches_s']:.1f} patches/s ({run['wall_s']:.2f} s), device"
          f" busy {run['busy']:.1%}, peak {run['peak_gib']:.2f} GiB; {card}")
    check(run["launches"] == {"fused_preprocess": 0, "window_attention": 0},
          f"(p) the classifier's K1 and K2 launches {run['launches']} (0: Scale takes the torch"
          " preprocess)")
    results = URIPath(tmp.name) / "results"
    (results / "model-outputs-csv").mkdir(parents=True, exist_ok=True)
    csv = results / "model-outputs-csv" / "cells.csv"
    write_slide_csv(csv, coords, probs, cfg.class_names)
    overlap = compute_overlap(cfg, 0.0, 0.0, 0, object_based=True)
    t0 = time.perf_counter()
    write_geojsons(csvs=[csv], overlap=overlap, results_dir=results,
                   output_dir="model-outputs-geojson", prefix="prob", num_workers=1,
                   object_type="detection", set_classification=True, show_progress=False)
    stats["geojson_s"] = time.perf_counter() - t0
    df = pd.read_csv(str(csv))
    with open(f"{results}/model-outputs-geojson/cells.geojson") as fh:
        feats = json.load(fh)["features"]
    centroids = {tuple(np.rint(polygon_centroid(r.astype(np.float64))).astype(int))
                 for r in plan.polygons}
    half = int(round(ps / 2))
    own = all((int(x) + half, int(y) + half) in centroids for x, y in plan.coords)
    p = df[[f"prob_{c}" for c in cfg.class_names]].to_numpy(np.float64)
    dsum = float(np.abs(p.sum(axis=1) - 1.0).max())
    check(len(df) == len(feats) == n_coords and own and bool(np.isfinite(p).all())
          and dsum <= 1e-5 and all(f["properties"]["objectType"] == "detection" for f in feats),
          f"(p) one CSV row ({len(df)}) and one GeoJSON detection ({len(feats)}) per planned"
          f" nucleus ({n_coords}), each nucleus's star polygon among the plan's {n_nuclei};"
          f" rows finite, summing to 1 within {dsum:.3g}; write_geojsons {stats['geojson_s']:.2f} s")
    del engine
    torch.cuda.empty_cache()
    tmp.cleanup()
    weights_dir.cleanup()
    print(f"    (p) took {time.perf_counter() - t_p:.1f} s;"
          f" {_smi('clocks.sm,power.draw,temperature.gpu')} (SM clock, power, temperature)")
    return stats


# (q): CellViT-Virchow-x40-AMP as the registry holds it (ViT-H/14 with SwiGLU
# and LayerScale, 256 px, halo 46), seeded (randomize_cell_model: LayerScale
# gains U[0.1, 1]).
VIRCHOW_MODEL = "CellViT-Virchow-x40-AMP"
# (r): the analytics. PanNuke's classes (the cell models' class names), the
# second cell table's size (above train_dgi_multi's max_nodes_cap of 16,384,
# so its subgraph sampler runs: a biopsy at 40x holds 1e5-1e6 cells) and
# H-Optimus' batch (the JAX package's extractor batch).
PANNUKE = ("Background", "Neoplastic", "Inflammatory", "Connective", "Dead", "Epithelial")
BIG_CELLS = 110_000
WINDOW_CELLS = 20_000  # the annotation merge's share of it: above the cap too
HOPTIMUS_BATCH = 64
CME_EPOCHS = 300  # the CLI's default
CME_RESOLUTIONS = "0.25,0.5,1.0,2.0"  # the CLI's default


def slide_csv_checks(check, what, engine, out, csv_path, bf16_maps=False) -> None:
    """(l)'s, (q)'s and (s)'s checks on a cell slide's output: the lists
    aligned, every polygon inside its bbox, the CSV through write_slide_csv
    one row per instance under the model's header, finite, rows summing to 1
    within K/2 levels (the quantized transfer), or within K half-ulps of bf16
    at 1 (2^-9 each; ``bf16_maps``: the streaming engine's bands)."""
    import pandas as pd

    from wsinsight_tpu_torch.engine.runner import write_slide_csv
    from wsinsight_tpu_torch.uri_path import URIPath

    cfg = engine.config
    boxes, probs, polys = out
    inside = all(len(r) >= 3 and (r.min(0) >= b[0, :2]).all()
                 and (r.max(0) <= b[0, :2] + b[0, 2:] - 1).all() for b, r in zip(boxes, polys))
    check(len(boxes) == len(probs) == len(polys) and inside,
          f"{what}: boxes, probabilities and polygons aligned ({len(boxes)}, {len(probs)},"
          f" {len(polys)}), every polygon (>= 3 vertices) inside its bbox")
    k = cfg.num_classes
    coords_arr = np.concatenate(boxes) if boxes else np.zeros((0, 4), np.int32)
    probs_arr = np.concatenate(probs) if probs else np.zeros((0, k), np.float32)
    write_slide_csv(URIPath(csv_path), coords_arr, probs_arr, cfg.class_names)
    header = ",".join(["minx", "miny", "width", "height"] + [f"prob_{c}" for c in cfg.class_names])
    with open(csv_path) as fh:
        first = fh.readline().strip()
    df = pd.read_csv(csv_path)
    p = df[[f"prob_{c}" for c in cfg.class_names]].to_numpy(dtype=np.float64)
    dsum = float(np.abs(p.sum(axis=1) - 1.0).max()) if len(p) else 0.0
    bar, unit = (k * 2.0**-9, "K x 2^-9, bf16 bands") if bf16_maps else (
        k * 0.5 / 255, "K x 1/2 level, quantized transfer")
    check(first == header and len(df) == len(boxes) and bool(np.isfinite(p).all())
          and dsum <= bar + 1e-6,
          f"{what}: the CSV has one row per instance ({len(df)}) under {header}, rows finite,"
          f" summing to 1 within {dsum:.3g} (<= {unit})")


def virchow_phase(check, kernels, card, rng, dev, cell_slide) -> dict:
    """(q): CellViT-Virchow-x40-AMP resident in parity and bf16 (as (g)),
    then (l)'s slide through it in bf16: plan_slide (halo grid) ->
    stitch_slide -> finalize -> the CSV."""
    import torch

    from wsinsight_tpu_torch.cli.infer import default_infer_workers, default_stitch_workers
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils.workers import governed_workers

    t0 = time.perf_counter()
    resident, engines = resident_cell_phase(check, kernels, rng, dev, "q", "q", VIRCHOW_MODEL, 32)
    engine = engines[True]
    del engines[False]
    torch.cuda.empty_cache()
    path = cell_slide[0]
    cfg = engine.config
    plan, ctx, *_ = plan_slide(URIPath(path), None, None, None, cfg.patch_size_pixels,
                               cfg.spacing_um_px, cfg.halo_size_pixels, object_based=True,
                               object_detection="end2end")  # the CLI's defaults
    dims = ctx.slide.dimensions
    ctx.slide.close()
    workers = governed_workers(default_infer_workers())
    stitch_workers = default_stitch_workers()
    n_batches = -(-len(plan.coords) // CELL_BATCH)
    st, out, run = run_cell_slide(engine, kernels, path, plan.coords, plan.patch_size, dims,
                                  workers, stitch_workers)
    host = run["host_shares"]
    print(f"    (l)'s slide in bf16, {run['patches']} patches ({n_batches} batches of"
          f" B={CELL_BATCH}): {run['patches_s']:.1f} patches/s without the finalize"
          f" ({run['wall_s']:.2f} s), {run['patches_s_with_finalize']:.1f} with it; device busy"
          f" {run['busy']:.1%}; main thread: decode wait {host['decode_wait']:.1%}, put"
          f" {host['put']:.1%}, dispatch {host['dispatch']:.1%}, scatter {host['scatter']:.1%};"
          f" finalize {run['finalize_s']:.2f} s; foreground {run['foreground']:.2%},"
          f" {run['instances']} instances; peak {run['peak_gib']:.2f} GiB; {card}")
    k2 = run["launches"]["window_attention"]
    check(k2 == 32 * run["batches"] and run["batches"] == n_batches,
          f"(q) slide: K2 launches {k2} (32 per batch x {run['batches']} batches)")
    check(run["launches"]["fused_preprocess"] == 0, "(q) slide: K1 launches 0")
    tmp = tempfile.TemporaryDirectory()
    slide_csv_checks(check, "(q) slide", engine, out, f"{tmp.name}/virchow.csv")
    st.close()
    tmp.cleanup()
    del engine, engines
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"    (q) took {secs:.1f} s; {_smi('clocks.sm,power.draw,temperature.gpu')}"
          " (SM clock, power, temperature)")
    launches = run["launches"]["window_attention"] + sum(
        st["launches"]["window_attention"] for st in resident.values())
    return {"resident": resident, "slide": run, "k2_launches": launches, "seconds": secs}


def typed_cells(centres, radii, nests, rng) -> "pd.DataFrame":
    """A cell table in the cell path's CSV schema (minx, miny, width, height,
    prob_<PanNuke class>) with seeded types: Neoplastic inside the tumour
    nests (centre x, y, radius), Inflammatory in a band 1.5 radii wide
    around them, Connective, Dead or Epithelial elsewhere; the type's
    probability 0.55-0.9, the rest spread over the other classes."""
    import pandas as pd

    n = len(centres)
    d = np.full(n, np.inf)
    for x, y, r in nests:
        d = np.minimum(d, np.hypot(centres[:, 0] - x, centres[:, 1] - y) / r)
    kind = np.where(d < 1.0, 1, np.where(d < 1.5, 2, rng.choice([3, 4, 5], n, p=[0.6, 0.1, 0.3])))
    rest = rng.dirichlet(np.ones(len(PANNUKE)), n)
    top = rng.uniform(0.55, 0.9, n)
    probs = rest * (1 - top)[:, None]
    probs[np.arange(n), kind] += top
    half = radii.max(axis=1)
    df = pd.DataFrame({"minx": centres[:, 0] - half, "miny": centres[:, 1] - half,
                       "width": 2 * half + 1, "height": 2 * half + 1})
    for i, c in enumerate(PANNUKE):
        df[f"prob_{c}"] = probs[:, i].astype(np.float32)
    return df


def cme_outputs_check(check, tag, results, stems) -> dict:
    """The CME CSVs: each slide's cell CSV holds every input cell once, the
    kept cells (the run's slide graph) with one-hot cme_* columns and the
    others none; for the slides in ``stems`` (run with the annotation
    merge) the region CSV, WKT polygons with areas."""
    import pickle

    import pandas as pd

    with open(f"{results}/slide-graphs.joblib", "rb") as fh:
        graphs = pickle.load(fh)
    out = {}
    for stem, slide in zip(graphs["stems"], graphs["slides"]):
        cells = pd.read_csv(f"{results}/cme-outputs-csv/cells/{stem}.csv")
        source = pd.read_csv(f"{results}/model-outputs-csv/{stem}.csv")
        cols = [c for c in cells.columns if c.startswith("cme_")]
        oh = cells[cols].to_numpy()
        kept = np.zeros(len(cells), bool)
        kept[slide["kept_idx"]] = True
        one_hot = bool(np.isin(oh[kept], (0.0, 1.0)).all()) and bool(
            (oh[kept].sum(1) == 1).all())
        check(len(cells) == len(source) and one_hot and bool(np.isnan(oh[~kept]).all()),
              f"({tag}) {stem}: the cell CSV holds its {len(source)} cells once, the"
              f" {int(kept.sum())} kept ones with one-hot {cols[0]}..{cols[-1]}, the"
              f" {int((~kept).sum())} isolated ones none")
        out[stem] = {"cells": len(source), "kept": int(kept.sum()), "cmes": len(cols),
                     "cme_sizes": np.bincount(oh[kept].argmax(1), minlength=len(cols)).tolist()}
        region = f"{results}/cme-outputs-csv/cmes/{stem}.csv"
        if stem in stems:
            reg = pd.read_csv(region) if os.path.exists(region) else pd.DataFrame(
                {"polygon_wkt": [], "area": []})
            check(len(reg) > 0 and reg["polygon_wkt"].str.startswith("POLYGON").all()
                  and bool((reg["area"] > 0).all()),
                  f"({tag}) {stem}: {len(reg)} CME regions, WKT polygons with positive areas")
            out[stem]["regions"] = len(reg)
    return out


def analytics_phase(check, kernels, card, rng, dev, cell_slide) -> dict:
    """(r): the analytics over (l)'s nuclei and a second cell table of
    BIG_CELLS nuclei: hplot_generation and cme_generation (the Leiden sweep,
    CME_EPOCHS of DGI on the card), then cme_generation with the H-Optimus
    branch (the port's FoundationViT on the card over SlideCropSource
    crops of (l)'s slide)."""
    import pandas as pd
    import torch

    import wsinsight_tpu_torch.insightlib.foundation as foundation_mod
    from wsinsight_tpu_torch.insightlib import cme_generation, hplot_generation
    from wsinsight_tpu_torch.insightlib.foundation import vit_hoptimus_extractor
    from wsinsight_tpu_torch.insightlib.gnn import DGI, make_dgi_train_step, pad_graph
    from wsinsight_tpu_torch.models.vit import HOPTIMUS_VIT_G, FoundationViT
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils.profiling import hot_stage_report
    from wsinsight_tpu_torch.wsi import get_wsi_cls
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff
    from wsinsight_tpu_torch.zoo import randomize_weights

    def stages() -> dict:  # cme_generation's phases, as the library times them
        return {k.split(".", 1)[1]: v for k, v in hot_stage_report().items()
                if k.startswith("cme.")}

    t_phase = time.perf_counter()
    stats = {"card": card}
    path, _, nuclei, _ = cell_slide
    tmp = tempfile.TemporaryDirectory()
    results = f"{tmp.name}/results"
    os.makedirs(f"{results}/model-outputs-csv")
    # (l)'s drawn nuclei with seeded types: tumour nests where the tissue is
    centres, radii, _ = nuclei
    pick = rng.choice(len(centres), 4, replace=False)
    nests = [(float(centres[i, 0]), float(centres[i, 1]), float(rng.uniform(500, 900)))
             for i in pick]
    small = typed_cells(centres.astype(np.float64), radii, nests, rng)
    small.to_csv(f"{results}/model-outputs-csv/cells.csv", index=False)
    # the second table on the cheapest slide that carries an mpp (its pixels
    # are never read): uniform nuclei at (l)'s density over a square of tissue
    big_side = int((BIG_CELLS * NUCLEUS_AREA) ** 0.5)
    big_path = f"{tmp.name}/biopsy.tif"
    write_pyramidal_tiff(big_path, np.full((256, 256, 3), 200, np.uint8), tile=(256, 256),
                         compression="deflate", mpp=SLIDE_MPP, levels=1)
    big_centres = rng.uniform(0, big_side, (BIG_CELLS, 2))
    big_radii = rng.integers(*NUCLEUS_RADII, (BIG_CELLS, 2), endpoint=True)
    big_nests = [(x, y, r) for x, y, r in zip(rng.uniform(0.1, 0.9, 12) * big_side,
                                              rng.uniform(0.1, 0.9, 12) * big_side,
                                              rng.uniform(800, 2000, 12))]
    big = typed_cells(big_centres, big_radii, big_nests, rng)
    big.to_csv(f"{results}/model-outputs-csv/biopsy.csv", index=False)
    # the annotation merge's window of it: the WINDOW_CELLS nuclei nearest
    # the square's centre, on another such slide
    window_path = f"{tmp.name}/window.tif"
    write_pyramidal_tiff(window_path, np.full((256, 256, 3), 200, np.uint8), tile=(256, 256),
                         compression="deflate", mpp=SLIDE_MPP, levels=1)
    near = np.argsort(np.abs(big_centres - big_side / 2).max(1), kind="stable")[:WINDOW_CELLS]
    wresults = f"{tmp.name}/window"
    os.makedirs(f"{wresults}/model-outputs-csv")
    big.iloc[np.sort(near)].to_csv(f"{wresults}/model-outputs-csv/window.csv", index=False)
    slides = [URIPath(path), URIPath(big_path)]
    print(f"(r) analytics: (l)'s {len(small)} drawn nuclei (cells.csv) and {len(big)} nuclei over"
          f" a {big_side * SLIDE_MPP / 1000:.1f} mm square (biopsy.csv, on a 256 px slide that"
          f" carries the mpp), seeded PanNuke types around {len(nests)} and {len(big_nests)}"
          f" tumour nests; {card}")

    # H-Plot over both slides (host)
    t0 = time.perf_counter()
    failed = hplot_generation(wsi_paths=slides, results_dir=URIPath(results),
                              base_type_list=["Neoplastic"], target_type_list=["Inflammatory"],
                              num_workers=2)
    hplot_s = time.perf_counter() - t0
    layers = pd.read_csv(f"{results}/hplot-outputs.csv")
    metrics = pd.read_csv(f"{results}/hmetrics-outputs.csv")
    vals = layers[["value", "distance"]].to_numpy(np.float64)
    num = metrics.drop(columns=["id", "valid"]).to_numpy(np.float64)
    stats["hplot"] = {"seconds": hplot_s, "layers": len(layers), "metrics_rows": len(metrics)}
    print(f"    hplot_generation: {hplot_s:.2f} s for 2 slides (host), {len(layers)} layer rows,"
          f" {len(metrics)} metrics rows")
    value = vals[:, 0]
    metric_cols = metrics.drop(columns=["id", "valid"]).columns
    undefined = sorted({c for c, bad in zip(metric_cols, np.isnan(num).any(0)) if bad})
    check(failed == [] and len(metrics) == 2 and set(layers["id"]) == {"cells", "biopsy"}
          and bool(np.isfinite(vals).all()) and bool(((value >= 0) & (value <= 1)).all())
          and not np.isinf(num).any() and all("enrichment_index" in c for c in undefined),
          f"(r) H-Plot: both slides' layers and metrics; every one of the {len(vals)} layer"
          " rows finite, its value in [0, 1]; every metric finite but"
          f" {int(np.isnan(num).sum())} of {num.size} NaN, all enrichment indices"
          f" ({', '.join(undefined) or 'none'}: undefined where a layer range is not valid,"
          " as the JAX package writes them)")

    # CME over both slides: graphs, DGI on the card, the Leiden sweep, cells
    torch.cuda.reset_peak_memory_stats()
    hot_stage_report(reset=True)
    t0 = time.perf_counter()
    cme_generation(wsi_paths=slides, results_dir=URIPath(results), epochs=CME_EPOCHS,
                   cme_cellular=True, cme_clustering_k=0,
                   cme_clustering_resolutions=CME_RESOLUTIONS)
    cme_s = time.perf_counter() - t0
    sec = stages()
    dgi_s = sec["dgi"] - sec["embed_full_graph"]
    stats["cme"] = {"seconds": cme_s, "stages_s": dict(sec), "dgi_epochs_s": CME_EPOCHS / dgi_s,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "outputs": cme_outputs_check(check, "r", results, ())}
    print(f"    cme_generation (cellular, both slides, {CME_EPOCHS} epochs, resolutions"
          f" {CME_RESOLUTIONS}): {cme_s:.2f} s; graph build {sec['graph_build']:.2f} s (host),"
          f" DGI {dgi_s:.2f} s on the card ({CME_EPOCHS / dgi_s:.1f} epochs/s; the"
          f" {BIG_CELLS}-cell graph on sampled subgraphs of 16,384), full-graph embedding"
          f" {sec['embed_full_graph']:.2f} s (host), Leiden sweep {sec['leiden_sweep']:.2f} s"
          f" (kNN and silhouettes on the card); peak {stats['cme']['peak_gib']:.2f} GiB; {card}")
    print(f"    CMEs: {json.dumps(stats['cme']['outputs'])}")

    # the annotation merge (phase 5) on the window of the large table
    hot_stage_report(reset=True)
    t0 = time.perf_counter()
    cme_generation(wsi_paths=[URIPath(window_path)], results_dir=URIPath(wresults),
                   epochs=CME_EPOCHS, cme_cellular=True, cme_annotation=True,
                   cme_clustering_k=0, cme_clustering_resolutions=CME_RESOLUTIONS)
    wcme_s = time.perf_counter() - t0
    sec = stages()
    stats["window"] = {"seconds": wcme_s, "stages_s": sec,
                       "outputs": cme_outputs_check(check, "r", wresults, ("window",))}
    ws = stats["window"]["outputs"]["window"]
    print(f"    cme_generation on {WINDOW_CELLS} of its nuclei (cellular and annotation):"
          f" {wcme_s:.2f} s; graph build {sec['graph_build']:.2f} s, DGI {sec['dgi']:.2f} s,"
          f" Leiden sweep {sec['leiden_sweep']:.2f} s, Voronoi merge"
          f" {sec['voronoi_merge']:.2f} s ({ws['kept'] / sec['voronoi_merge']:.0f} cells/s,"
          f" host) into {ws['regions']} regions; {card}")

    # one DGI step on the card against the CPU, same weights and inputs
    import pickle

    with open(f"{results}/slide-graphs.joblib", "rb") as fh:
        graph = pickle.load(fh)["slides"][0]
    n = graph["X_normalized"].shape[0]
    g = pad_graph(graph["X_normalized"], graph["edge_index"], -(-(n + 1) // 8) * 8,
                  -(-graph["edge_index"].shape[1] // 8) * 8)
    perm = np.arange(len(g.x))
    perm[:n] = np.random.default_rng(SEED).permutation(n)
    losses = {}
    for where in ("cpu", dev):
        model = DGI(g.x.shape[1], seed=SEED).to(where)
        step = make_dgi_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
        x = torch.from_numpy(g.x)[None].to(where)
        losses[str(where)] = float(step(
            x, x[:, torch.from_numpy(perm).to(where)],
            torch.from_numpy(g.edges.astype(np.int64))[None].to(where),
            torch.from_numpy(g.edge_mask)[None].to(where),
            torch.from_numpy(g.node_mask)[None].to(where),
            torch.from_numpy(g.loss_mask)[None].to(where)))
    rel = abs(losses[str(dev)] - losses["cpu"]) / abs(losses["cpu"])
    check(rel <= 1e-4, f"(r) one DGI step on (l)'s graph ({n} nodes): loss {losses[str(dev)]:.7g}"
          f" on the card, {losses['cpu']:.7g} on the CPU, relative {rel:.2g} (<= 1e-4)")

    # H-Optimus: seeded ViT-g/14 at full width and depth, on the card
    t0 = time.perf_counter()
    host_model = randomize_weights(FoundationViT(HOPTIMUS_VIT_G, img_size=224).eval(), SEED)
    state = host_model.state_dict()
    build_s = time.perf_counter() - t0
    source = foundation_mod.SlideCropSource(get_wsi_cls()(path), centres[:2].astype(np.int64))
    crops = np.stack([source[0], source[1]])
    parity = vit_hoptimus_extractor(state_dict=state, batch_size=2, mixed_precision=False,
                                    device=dev)
    on_card = parity(crops)
    with torch.no_grad():
        mean = torch.tensor(foundation_mod.HOPTIMUS_MEAN)
        std = torch.tensor(foundation_mod.HOPTIMUS_STD)
        on_host = host_model((torch.from_numpy(crops).float() / 255.0 - mean) / std).numpy()
    err = float(np.abs(on_card - on_host).max())
    print(f"    H-Optimus-0 (ViT-g/14: {HOPTIMUS_VIT_G.embed_dim} wide, {HOPTIMUS_VIT_G.depth}"
          f" blocks, {HOPTIMUS_VIT_G.num_heads} heads, {HOPTIMUS_VIT_G.reg_tokens} registers;"
          f" {sum(p.numel() for p in host_model.parameters()) / 1e6:.1f} M seeded parameters,"
          f" {build_s:.1f} s on the host)")
    check(err <= 1e-3, f"(r) H-Optimus parity on the card vs the CPU, 2 crops: max |d| {err:.3g}"
          " (<= 1e-3)")
    del parity, host_model
    torch.cuda.empty_cache()

    extractor = vit_hoptimus_extractor(state_dict=state, batch_size=HOPTIMUS_BATCH,
                                       mixed_precision=True, device=dev)
    del state
    crop_stats = {"crops": 0, "batches": 0, "seconds": 0.0}

    def timed_extractor(images):
        t = time.perf_counter()
        out = extractor(images)
        crop_stats["seconds"] += time.perf_counter() - t
        crop_stats["crops"] += len(images)
        crop_stats["batches"] += -(-len(images) // HOPTIMUS_BATCH)
        return out

    hresults = f"{tmp.name}/hoptimus"
    os.makedirs(f"{hresults}/model-outputs-csv")
    small.to_csv(f"{hresults}/model-outputs-csv/cells.csv", index=False)
    torch.cuda.reset_peak_memory_stats()
    hot_stage_report(reset=True)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    cme_generation(wsi_paths=[URIPath(path)], results_dir=URIPath(hresults),
                   epochs=CME_EPOCHS, use_hoptimus=True, feature_extractor=timed_extractor,
                   cme_cellular=True, cme_annotation=True, cme_clustering_k=0,
                   cme_clustering_resolutions=CME_RESOLUTIONS)
    hcme_s = time.perf_counter() - t0
    launches = {name: fn.launches for fn, name in kernels.items()}
    k2 = launches["window_attention"]
    sec = stages()
    stats["hoptimus"] = {
        "seconds": hcme_s, "stages_s": dict(sec), "crops": crop_stats["crops"],
        "batches": crop_stats["batches"], "crops_s": crop_stats["crops"] / crop_stats["seconds"],
        "crops_s_with_read": crop_stats["crops"] / sec["foundation_block"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "k2_launches": k2,
        "k1_launches": launches["fused_preprocess"],
        "outputs": cme_outputs_check(check, "r", hresults, ("cells",)),
        "build_s": build_s}
    hs = stats["hoptimus"]
    print(f"    cme_generation with H-Optimus on (l)'s slide (cellular and annotation):"
          f" {hcme_s:.2f} s; {hs['crops']} crops of 224 px in {hs['batches']} batches of"
          f" B={HOPTIMUS_BATCH}: {hs['crops_s']:.1f} crops/s on the card (bf16),"
          f" {hs['crops_s_with_read']:.1f} over the whole block (the crops' reads, PCA and"
          f" imputation); graph build"
          f" {sec['graph_build']:.2f} s, DGI {sec['dgi']:.2f} s, Leiden sweep"
          f" {sec['leiden_sweep']:.2f} s, Voronoi merge {sec['voronoi_merge']:.2f} s"
          f" ({hs['outputs']['cells']['kept'] / max(sec['voronoi_merge'], 1e-9):.0f} cells/s,"
          f" host); peak {hs['peak_gib']:.2f} GiB; {card}")
    check(k2 == 40 * crop_stats["batches"] and crop_stats["batches"] > 0,
          f"(r) H-Optimus: K2 launches {k2} (40 per batch x {crop_stats['batches']} batches)")
    check(hs["k1_launches"] == 0, "(r) K1 launches 0")
    del extractor
    torch.cuda.empty_cache()
    tmp.cleanup()
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"    (r) took {stats['seconds']:.1f} s; {_smi('clocks.sm,power.draw,temperature.gpu')}"
          " (SM clock, power, temperature)")
    return stats


def resident_cell_phase(check, kernels, rng, dev, phase, tag, model_name, per_batch):
    """(g), (h), (q): a cell model's CellEngine in parity and bf16 over
    CELL_BATCHES resident batches of B=CELL_BATCH seeded patches (seeded
    weights), through device_postprocess -> scatter, then its result checks
    (printed under ``tag``). Returns (stats per mode, the two engines)."""
    import torch

    from wsinsight_tpu_torch.engine import CellEngine, TileRemapStitcher
    from wsinsight_tpu_torch.zoo import get_registered_model

    side = CELL_GRID * 164
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
    check(err <= 1e-3, f"({tag}) {model_name} parity on the card vs the CPU, 2 patches:"
          f" max |d| of the maps {err:.3g} (<= 1e-3)")
    p32, p16 = stitchers[False], stitchers[True]
    d_np = float(np.abs(p16.np_map - p32.np_map).max())
    d_hv = float(np.abs(p16.hv_map - p32.hv_map).max())
    d_tp = float(np.abs(p16.tp_map - p32.tp_map).max())
    np_flip = float(np.mean((p16.np_map > 0.5) != (p32.np_map > 0.5)))
    tp_flip = float(np.mean(p16.tp_map.argmax(-1) != p32.tp_map.argmax(-1)))
    check(np_flip <= 0.01, f"({tag}) {model_name} bf16 vs parity over {side}x{side} px: max |d|"
          f" NP {d_np:.3g}, HV {d_hv:.3g}, TP {d_tp:.3g}; NP > 0.5 differs on"
          f" {np_flip:.3%} (<= 1%), TP argmax on {tp_flip:.3%}")
    for mode, st in (("parity", p32), ("bf16", p16)):
        ok = all(bool(np.isfinite(m).all()) for m in (st.np_map, st.hv_map, st.tp_map))
        # uint8 transfer: each of K probabilities is within half a level
        tp_sum = float(np.abs(st.tp_map.sum(-1) - 1.0).max())
        check(ok and tp_sum <= cfg.num_classes * 0.5 / 255 + 1e-6,
              f"({tag}) {model_name} {mode} canvas finite, TP rows sum to 1 within"
              f" {tp_sum:.3g} (quantized transfer, <= K/2 levels)")
    exact = TileRemapStitcher(cfg.num_classes, side, side, out_px, cfg.halo_size_pixels,
                              0.25, cfg.spacing_um_px, transfer_dtype="float32")
    maps = [m.cpu().numpy() for m in exact.device_postprocess(on_card)]
    tp_sum = float(np.abs(maps[2].sum(-1) - 1.0).max())
    check(all(np.isfinite(m).all() for m in maps) and tp_sum <= 1e-5,
          f"({tag}) {model_name} float32 maps finite, TP rows sum to 1 within {tp_sum:.3g}")
    del data, cpu_engine, stitchers, p32, p16, exact, on_card, on_host
    return stats, engines


# (t)'s child process: one host of a two-process run under a coordinator.
# It joins the group, classifies its round-robin share of the sorted slides
# on in-memory plans and writes each slide's result once ("xb" fails if
# another process wrote it already).
HOST_CHILD = r"""
import json, os, sys
import numpy as np
args = json.loads(sys.argv[1])
from wsinsight_tpu_torch.parallel.multihost import (
    maybe_initialize_distributed, process_info, shard_slides_for_host)
assert maybe_initialize_distributed(), "not multi-process"
rank, count = process_info()
from wsinsight_tpu_torch.engine import ClassifierEngine
from wsinsight_tpu_torch.engine.data import PatchBatchSource
from wsinsight_tpu_torch.engine.runner import classify_slide
from wsinsight_tpu_torch.zoo import load_local_model
engine = ClassifierEngine(load_local_model(args["config"], args["weights"]), device=args["device"])
mine = shard_slides_for_host(sorted(args["slides"]))
for path in mine:
    src = PatchBatchSource.from_coords(path, np.asarray(args["coords"]), args["ps"], args["batch"],
                                       num_threads=2)
    try:
        coords, probs = classify_slide(engine, src)
    finally:
        src.close()
    stem = os.path.splitext(os.path.basename(path))[0]
    with open(os.path.join(args["out"], stem + ".npz"), "xb") as fh:
        np.savez(fh, coords=coords, probs=probs, rank=rank)
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps({"rank": rank, "count": count, "slides": mine}))
"""
HOST_SLIDES = 4
HOST_SLIDE_PX = 1400  # a 4 x 4 grid of 350 px patches per slide
DGI_EPOCHS = 10


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def host_fanout(check, card, rng, dev, work: str, n_proc: int = 2) -> dict:
    """(t)'s multi-host part: ``n_proc`` processes on the card under one
    coordinator on 127.0.0.1 share HOST_SLIDES seeded slides through
    shard_slides_for_host and classify_slide; each slide is classified once,
    and the union's probabilities are one process's bit for bit."""
    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.engine.data import PatchBatchSource
    from wsinsight_tpu_torch.engine.runner import classify_slide
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff
    from wsinsight_tpu_torch.zoo import load_local_model, make_random_local_model

    t0 = time.perf_counter()
    slides = []
    for i in range(HOST_SLIDES):
        path = os.path.join(work, f"host_{i}.tif")
        img = rng.integers(90, 230, (HOST_SLIDE_PX, HOST_SLIDE_PX, 3), dtype=np.uint8)
        write_pyramidal_tiff(path, img, tile=(256, 256), compression="deflate", mpp=0.25)
        slides.append(path)
    ps = 350
    coords = np.array([(x, y) for y in range(0, HOST_SLIDE_PX - ps + 1, ps)
                       for x in range(0, HOST_SLIDE_PX - ps + 1, ps)], np.int32)
    cfg, weights = make_random_local_model("resnet34", 2, os.path.join(work, "host_model"),
                                           seed=SEED)
    engine = ClassifierEngine(load_local_model(cfg, weights), device=dev)
    want = {}
    for path in slides:
        src = PatchBatchSource.from_coords(path, coords, ps, 8, num_threads=2)
        try:
            want[path] = classify_slide(engine, src)[1]
        finally:
            src.close()
    del engine
    out = os.path.join(work, "host_out")
    os.makedirs(out)
    args = json.dumps({"config": str(cfg), "weights": str(weights), "device": str(dev),
                       "slides": slides, "coords": coords.tolist(), "ps": ps, "batch": 8,
                       "out": out})
    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    procs = []
    t1 = time.perf_counter()
    try:
        for i in range(n_proc):
            env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(n_proc), JAX_PROCESS_ID=str(i),
                       PYTHONPATH=os.pathsep.join(filter(None, [root,
                                                               os.getenv("PYTHONPATH")])))
            procs.append(subprocess.Popen([sys.executable, "-c", HOST_CHILD, args], cwd=root,
                                          env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t1
    shares = []
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        ok = p.returncode == 0
        check(ok, f"(t) host process {i} of {n_proc} exits 0 (exit {p.returncode})"
              + ("" if ok else f": {stderr.strip()[-2000:]}"))
        if ok:
            shares.append(json.loads(stdout.strip().splitlines()[-1]))
    done = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    by_rank = {}
    same = True
    for path in slides:
        stem = os.path.splitext(os.path.basename(path))[0]
        f = os.path.join(out, stem + ".npz")
        if not os.path.exists(f):
            same = False
            continue
        got = np.load(f)
        by_rank.setdefault(int(got["rank"]), []).append(stem)
        same = same and np.array_equal(got["probs"], want[path])
    union = sorted(sl for sh in shares for sl in sh["slides"])
    check(len(shares) == n_proc and union == sorted(slides) and len(done) == HOST_SLIDES
          and all(sh["count"] == n_proc for sh in shares),
          f"(t) {HOST_SLIDES} slides over {n_proc} processes: each classified once"
          f" (ranks' slides {dict(sorted(by_rank.items()))})")
    check(same, f"(t) the union's probabilities ({HOST_SLIDES} x {len(coords)} patches) equal"
          " one process's bit for bit")
    print(f"    (t) {n_proc} processes on one card under a coordinator: {wall:.1f} s of wall"
          f" from launch to exit (slides written and the one-process reference in"
          f" {t1 - t0:.1f} s) ({card})")
    return {"processes": n_proc, "wall_s": wall, "ranks": by_rank}


def dgi_on(devices, slides) -> tuple[dict, list, float]:
    """train_dgi_multi over ``devices`` (DGI_EPOCHS, seed SEED), and the
    trained DGI's loss on the padded graphs with a seeded corruption,
    evaluated on the first device: (state, embeddings, loss)."""
    import torch

    from wsinsight_tpu_torch.insightlib import gnn
    from wsinsight_tpu_torch.insightlib.cme import train_dgi_multi

    state, z = train_dgi_multi(slides, hidden=64, out_dim=32, epochs=DGI_EPOCHS, seed=SEED,
                               devices=devices)
    dev = torch.device(devices[0])
    model = gnn.DGI(slides[0]["X_normalized"].shape[1], hidden=64, out_dim=32).to(dev)
    model.load_state_dict(state)
    n_max = max(len(s["X_normalized"]) for s in slides) + 1
    e_max = max(s["edge_index"].shape[1] for s in slides)
    perm_rng = np.random.default_rng(SEED)
    loss = 0.0
    with torch.no_grad():
        for s in slides:
            g = gnn.pad_graph(s["X_normalized"], s["edge_index"], n_max, e_max)
            perm = np.arange(n_max)
            n = len(s["X_normalized"])
            perm[:n] = perm_rng.permutation(n)
            t = [torch.from_numpy(a).to(dev) for a in (g.x, g.x[perm], g.edges.astype(np.int64),
                                                       g.edge_mask, g.node_mask)]
            loss += float(model(*t)) / len(slides)
    return state, z, loss


def replica_phase(check, kernels, card, dev, handle, data, weights) -> dict:
    """(t): the engines and the DGI on a device list naming the card twice,
    against one replica; two host processes under a coordinator; and a
    torch checkpoint converted to flax msgpack by `models convert`, then
    classified. Returns its stats; its K1 and K2 launches under
    "launches". Its data come from a generator of its own, so the phases
    after it get the data they got before it was added."""
    import pandas as pd
    import torch
    from click.testing import CliRunner

    from wsinsight_tpu_torch.cli.cli import cli
    from wsinsight_tpu_torch.engine import CellEngine, ClassifierEngine
    from wsinsight_tpu_torch.insightlib import stats as wstats
    from wsinsight_tpu_torch.insightlib.cme import prepare_slide_graph
    from wsinsight_tpu_torch.parallel.mesh import resolve_devices
    from wsinsight_tpu_torch.zoo import ModelHandle, get_registered_model

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    stats = {"launches": {name: 0 for name in kernels.values()}}
    found = resolve_devices()
    print(f"(t) the default device list finds {len(found)} card(s):"
          f" {', '.join(map(str, found))} ({card})")
    check(len(found) == torch.cuda.device_count(),
          f"(t) the default device list is every visible card ({torch.cuda.device_count()})")
    pair = [dev, dev]

    # ResNet34, (d)'s resident batches: two replicas against one
    probs, rates = {}, {}
    for mixed in (False, True):
        for n, kw in ((1, dict(device=dev)), (2, dict(devices=pair))):
            engine = ClassifierEngine(handle, mixed_precision=mixed, **kw)
            engine.run_batch(data[0], BATCH)  # warm-up
            torch.cuda.synchronize()
            for fn in kernels:
                fn.launches = 0
            probs[mixed, n], secs = run_window(engine, data)
            rates[mixed, n] = len(data) * BATCH / secs
            counts = {name: fn.launches for fn, name in kernels.items()}
            if n == 2:
                for name, c in counts.items():
                    stats["launches"][name] += c
            if mixed and n == 2:
                check(counts["fused_preprocess"] == 2 * len(data),
                      f"(t) bf16 on two replicas: K1 launches {counts['fused_preprocess']}"
                      f" (two per batch x {len(data)})")
            del engine
        mode = "bf16" if mixed else "parity"
        print(f"    (t) ResNet34 {mode}, {len(data)} batches of B={BATCH}: one replica"
              f" {rates[mixed, 1]:.1f} patches/s, two replicas on the card"
              f" {rates[mixed, 2]:.1f} patches/s ({card})")
    err = float(np.abs(probs[False, 2] - probs[False, 1]).max())
    check(err <= 1e-5, f"(t) parity on two replicas vs one: max |dp| {err:.3g} (<= 1e-5)")
    err16 = float(np.abs(probs[True, 2] - probs[False, 1]).max())
    check(err16 <= 0.01, f"(t) bf16 on two replicas vs parity on one: max |dp| {err16:.3g}"
          " (<= 0.01)")
    stats["resnet34"] = {"patches_s": {f"{'bf16' if m else 'parity'}_{n}": r
                                       for (m, n), r in rates.items()},
                         "parity_max_abs": err, "bf16_vs_parity_max_abs": err16}
    torch.cuda.empty_cache()

    # CellViT-256 at (g)'s B=32: two replicas against one, parity
    cell = get_registered_model("CellViT-256-x40")
    ps = cell.config.patch_size_pixels
    cells = rng.integers(0, 256, (4, CELL_BATCH, ps, ps, 3), dtype=np.uint8)
    maps, k2, cell_rates = {}, {}, {}
    for n, kw in ((1, dict(device=dev)), (2, dict(devices=pair))):
        engine = CellEngine(cell, init_random=True, seed=SEED, **kw)
        engine.run_batch(cells[0])  # warm-up
        torch.cuda.synchronize()
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        outs = [engine.dispatch(engine.put(b)) for b in cells]
        torch.cuda.synchronize()
        cell_rates[n] = len(cells) * CELL_BATCH / (time.perf_counter() - t0)
        counts = {name: fn.launches for fn, name in kernels.items()}
        k2[n] = counts["window_attention"]
        if n == 2:
            for name, c in counts.items():
                stats["launches"][name] += c
        maps[n] = {k: v.cpu() for k, v in outs[0].items()}
        del engine, outs
    err = max(float((maps[2][k] - maps[1][k]).abs().max())
              for k in ("nuclei_binary_map", "hv_map", "nuclei_type_map"))
    check(err <= 1e-4, f"(t) CellViT-256 parity on two replicas vs one, B={CELL_BATCH}:"
          f" max |d| of the maps {err:.3g} (<= 1e-4)")
    check(k2[2] == 2 * k2[1] > 0, f"(t) K2 launches over {len(cells)} batches: two replicas"
          f" {k2[2]}, one {k2[1]} (doubled)")
    print(f"    (t) CellViT-256 parity, {len(cells)} batches of B={CELL_BATCH}: one replica"
          f" {cell_rates[1]:.1f} patches/s, two replicas {cell_rates[2]:.1f} patches/s ({card})")
    stats["cellvit_256"] = {"patches_s": cell_rates, "max_abs": err, "k2_launches": k2}
    torch.cuda.empty_cache()

    work = tempfile.TemporaryDirectory()
    try:
        # two host processes under a coordinator
        stats["hosts"] = host_fanout(check, card, rng, dev, work.name)

        # `models convert`: the torch checkpoint to flax msgpack, classified
        msgpack = os.path.join(work.name, "resnet34.msgpack")
        t0 = time.perf_counter()
        res = CliRunner().invoke(cli, ["models", "convert", str(weights), msgpack,
                                       "--architecture", "resnet34", "--num-classes", "2",
                                       "--report"])
        convert_s = time.perf_counter() - t0
        check(res.exit_code == 0 and "mapping complete" in res.output,
              f"(t) models convert --report: exit {res.exit_code},"
              f" {res.output.strip().splitlines()[0] if res.output.strip() else ''}"
              f" ({convert_s:.2f} s)")
        if res.exit_code == 0:
            direct = ClassifierEngine(handle, device=dev).run_batch(data[0], BATCH)
            conv = ClassifierEngine(ModelHandle(name=handle.name, config=handle.config,
                                                weights_path=msgpack), device=dev)
            check(np.array_equal(conv.run_batch(data[0], BATCH), direct),
                  f"(t) the converted msgpack's probabilities equal the state dict's bit for"
                  f" bit (B={BATCH})")
            del conv
    finally:
        work.cleanup()

    # the DGI over [card, card] against ["cpu", "cpu"]: 3 graphs padded to 4
    slides = []
    for n, seed in ((30, 1), (25, 2), (20, 3)):
        r = np.random.default_rng(seed)
        xs, ys = np.meshgrid(np.arange(n) * 10.0, np.arange(n) * 10.0)
        cx, cy = xs.ravel() + r.uniform(-2, 2, n * n), ys.ravel() + r.uniform(-2, 2, n * n)
        p = r.dirichlet(np.ones(3), n * n)
        df = pd.DataFrame({"minx": cx - 4, "miny": cy - 4, "width": 8, "height": 8,
                           "prob_a": p[:, 0], "prob_b": p[:, 1], "prob_c": p[:, 2]})
        slides.append(prepare_slide_graph(df, mpp_um_per_px=0.25, max_edge_len_um=4.0))
    scaler = wstats.StandardScaler().fit(np.vstack([s["X"] for s in slides]))
    for s in slides:
        s["X_normalized"] = scaler.transform(s["X"]).astype(np.float32)
    t0 = time.perf_counter()
    card_state, card_z, card_loss = dgi_on(pair, slides)
    torch.cuda.synchronize()
    dgi_s = time.perf_counter() - t0
    cpu_state, cpu_z, cpu_loss = dgi_on(["cpu", "cpu"], slides)
    w_err = max(float((card_state[k] - cpu_state[k]).abs().max()
                      / cpu_state[k].abs().max().clamp(min=1e-12)) for k in cpu_state)
    z_err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
                for a, b in zip(card_z, cpu_z))
    l_err = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-12)
    check(max(w_err, l_err) <= 1e-4,
          f"(t) DGI on two card replicas vs two CPU ones, 3 graphs padded to 4,"
          f" {DGI_EPOCHS} epochs: loss {card_loss:.6f} vs {cpu_loss:.6f} ({l_err:.3g}"
          f" relative), weights {w_err:.3g} relative to each tensor's largest (<= 1e-4);"
          f" embeddings {z_err:.3g}")
    print(f"    (t) DGI {DGI_EPOCHS} epochs on two replicas of the card: {dgi_s:.2f} s ({card})")
    stats["dgi"] = {"loss": [card_loss, cpu_loss], "weights_rel": w_err, "z_rel": z_err,
                    "seconds": dgi_s}
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"    (t) {stats['seconds']:.1f} s in all ({card})")
    return stats


def main() -> int:
    import torch

    # (a) ------------------------------------------------------------------
    clock = PhaseClock()
    clock("a")
    # (p) reads StarDist's stages from hot_stage_report(); the flag is read
    # when the port is first imported
    os.environ["WSINSIGHT_STREAM_PROFILE"] = "1"
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
    from wsinsight_tpu_torch.engine import ClassifierEngine
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
    clock("b")
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
    clock("c")
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
    clock("d")
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
        probs[mixed], secs = run_window(engine, data)
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
        pre = _cuda_ms(lambda: engine._preprocess(x[0]), reps=10)
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
    clock("e")
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
    del engines[True], cpu_engine
    torch.cuda.empty_cache()

    # (m) ------------------------------------------------------------------
    clock("m")
    zoo = zoo_phase(check, kernels, card, (handle, data, engines[False], probs[False]))

    # (t) ------------------------------------------------------------------
    clock("t")
    replicas = replica_phase(check, kernels, card, dev, handle, data, weights)
    tmp.cleanup()
    del data, engines
    torch.cuda.empty_cache()

    # (f) ------------------------------------------------------------------
    clock("f")
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
    clock("g+h")
    cell = {}
    for phase, (model_name, per_batch) in zip("gh", CELL_MODELS):
        stats, engines = resident_cell_phase(check, kernels, rng, dev, phase, "i", model_name,
                                             per_batch)
        cell[model_name] = stats
        if model_name == CELL_SLIDE_MODEL:  # kept for (l), on the host until then
            slide_engines = engines
            for engine in engines.values():
                engine.model.to("cpu")
        del engines
        torch.cuda.empty_cache()

    # (j) ------------------------------------------------------------------
    clock("j")
    slide = slide_phase(check, kernels, card, rng)

    # (l) ------------------------------------------------------------------
    clock("l")
    for engine in slide_engines.values():
        engine.model.to(dev)
    nuclei_tmp = tempfile.TemporaryDirectory()
    nuclei_path = f"{nuclei_tmp.name}/cells.tif"
    nuclei_slide = (nuclei_path, *write_nuclei_slide(nuclei_path, CELL_SLIDE_PX, rng))
    cell_slide = cell_slide_phase(check, kernels, card, rng, slide_engines, nuclei_slide)

    # (s) ------------------------------------------------------------------
    clock("s")
    stream = stream_phase(check, kernels, card, slide_engines, nuclei_slide, cell_slide)
    del slide_engines, cell_slide["drawn_maps"]
    torch.cuda.empty_cache()

    # (o) ------------------------------------------------------------------
    clock("o")
    hovernet = hovernet_phase(check, kernels, card, nuclei_slide)

    # (p) ------------------------------------------------------------------
    clock("p")
    stardist = stardist_phase(check, kernels, card, nuclei_slide)

    # (q) ------------------------------------------------------------------
    clock("q")
    virchow = virchow_phase(check, kernels, card, rng, dev, nuclei_slide)

    # (r) ------------------------------------------------------------------
    clock("r")
    analytics = analytics_phase(check, kernels, card, rng, dev, nuclei_slide)
    nuclei_tmp.cleanup()
    print(f"phase seconds (host clock): {json.dumps(clock.seconds())} ({card})")

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
    k2_launches += cell_slide["k2_launches"] + stream["k2_launches"] + virchow["k2_launches"]
    k2_launches += analytics["hoptimus"]["k2_launches"] + replicas["launches"]["window_attention"]
    record = {"kernels": [{
        "name": "fused_preprocess",
        "route": "cuda",
        "source": "wsinsight_tpu_torch/ops/csrc/fused_preprocess.cu",
        "replaces": "wsinsight_tpu/ops/pallas_preprocess.py:38",
        "launches": launches["fused_preprocess"] + slide["k1_launches"]
        + replicas["launches"]["fused_preprocess"] + sum(
            st["launches"]["fused_preprocess"] for name, model in zoo.items()
            if not name.startswith("precision") for st in (model["parity"], model["bf16"])),
        "max_abs_err": max_abs_err,
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
        "at": f"B={BATCH} {k1_main['shape']} {k1_main['dtype']}",
        "not_launched_on": NO_KERNEL_PATHS,
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
        "not_launched_on": NO_KERNEL_PATHS,
        "shapes": k2["shapes"],
    }]}
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"cells": cell}))
    print(json.dumps({"slide": slide["stats"]}))
    print(json.dumps({"cell_slide": cell_slide["stats"]}))
    print(json.dumps({"stream_cells": stream["stats"]}))
    print(json.dumps({"hovernet": hovernet}))
    print(json.dumps({"stardist": stardist}))
    print(json.dumps({"virchow": virchow}))
    print(json.dumps({"analytics": analytics}))
    print(json.dumps({"replicas": replicas}, default=str))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
