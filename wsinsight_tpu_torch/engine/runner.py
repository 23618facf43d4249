"""Patch classification: the engine (preprocess -> forward -> probabilities)
and ``run_inference``, which runs it over every slide's patches into CSVs.

Counterpart of wsinsight_tpu/engine/runner.py. ``ClassifierEngine`` has the
JAX engine's surface (``spec``, ``n_devices``, ``pad_batch``, ``put``,
``dispatch``, ``run_batch``, ``set_stains``). ``run_inference`` builds one per
run, and ``classify_slide`` calls it for each batch of a slide, two batches
deep::

    pending = deque()
    for images in batches:
        pending.append(engine.dispatch(engine.put(images)))
        if len(pending) > 2:
            probs = pending.popleft().cpu().numpy()

PyTorch runs eagerly, so the step is a plain method; ``dispatch`` enqueues it
on the current CUDA stream and returns without waiting.

The step takes what the source ships, chosen by its rank as in the JAX
step: (B, H, W, 3) RGB, or (B, H*3/2, W) planar YUV 4:2:0 (WSINSIGHT_WIRE),
rebuilt on the device. With stain matrices (``w_est``/``w_def``, swapped per
slide by ``set_stains``) it normalizes the stains before the preprocess.

WSINSIGHT_PRECISION takes the JAX engines' names for float32 matmul
precision and maps them onto TF32 (``precision_allows_tf32``): "highest",
"float32" and "high" keep TF32 off (parity's setting, and the setting when
the variable is unset); "default" turns it on. The flags are set around each
step (``tf32_flags``), so engines of different settings share a process.

``run_inference`` has every branch of the JAX function: patch
classification (the default) with its stain normalization, host resize
(WSINSIGHT_HOST_RESIZE) and wire (WSINSIGHT_WIRE) read per slide, its
cross-slide source prefetch, resume and CSV schema
(``minx,miny,width,height,prob_<class>...``); the end2end cell branch
(``engine/cells.run_cell_inference``: one CSV row per nucleus, the polygons
into the patch file's ``/polygons`` group); the QuPath pseudo-models (TSV
detections, GeoJSON detections, GeoJSON annotations: one-hot rows, no
engine and no device); and the references overlay (``annot_prob_*``) on
object-based rows. With a coordinator set (``parallel/multihost.py``) each
process runs its round-robin share of the sorted slides.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import logging
import os
import threading
from collections import deque
from typing import Iterator, List

import numpy as np
import pandas as pd
import torch
import tqdm

from .. import errors
from ..geometry import polygon_centroid
from ..models import create_model
from ..ops.fused_preprocess import make_fused_preprocess_fn
from ..ops.preprocess import TransformSpec, make_preprocess_fn, yuv420_to_rgb
from ..ops.stain import (
    EPSILON,
    deconvolution_based_normalization,
    default_target_stains,
    estimate_stains_from_batch,
)
from ..parallel.mesh import device_batch_size, on_device, resolve_device, resolve_devices
from ..parallel.multihost import maybe_initialize_distributed, shard_slides_for_host
from ..uri_path import URIPath
from ..utils.profiling import hot_stage, maybe_trace
from ..utils.workers import governed_workers
from ..wsi import _validate_wsi_directory
from ..zoo import ModelHandle
from .data import Batch, PatchBatchSource

logger = logging.getLogger(__name__)


# WSINSIGHT_PRECISION's values (the JAX engines' matmul precisions) -> TF32.
_PRECISION_TF32 = {"highest": False, "float32": False, "high": False, "default": True}


def precision_allows_tf32() -> bool:
    """Whether an engine's float32 matmuls and cuDNN convolutions may use
    TF32, from WSINSIGHT_PRECISION: "highest", "float32" and "high" (and no
    value) keep them in float32, "default" allows TF32. Read when an engine
    is built; any other value raises ``ValueError``."""
    value = os.getenv("WSINSIGHT_PRECISION", "")
    if value and value not in _PRECISION_TF32:
        raise ValueError(
            f"WSINSIGHT_PRECISION={value!r}: expected one of {sorted(_PRECISION_TF32)}")
    return _PRECISION_TF32.get(value, False)


@contextlib.contextmanager
def tf32_flags(allow: bool):
    """Set TF32 for CUDA matmuls and cuDNN convolutions to ``allow`` for the
    block, then restore the process's flags. Kernels are chosen when they are
    enqueued, so an asynchronous step needs the flags only while it is
    dispatched."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def _gather(outs: list, device: torch.device):
    """The replicas' results (tensors, or dicts of them) concatenated in row
    order on ``device``; a lone result as it is, with no copy."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], dict):
        return {k: _gather([o[k] for o in outs], device) for k in outs[0]}
    return torch.cat([o.to(device, non_blocking=True) for o in outs])


class Replicated:
    """What both engines share: the devices (``resolve_devices``), one
    replica of the model on each (``models``; ``model`` is the first; a
    device named twice gets two), and the batch's way through them. ``put``
    splits a batch into equal row blocks; ``dispatch`` runs block i's
    ``_step`` on replica i under its device and gathers the results in row
    order on the first device (``device``), as the JAX step's replicated
    output does. One device is one block: the batch as it came, no copy."""

    def _place(self, model: torch.nn.Module, devices, device, max_devices,
               **to_kwargs) -> None:
        self.devices = resolve_devices(devices, device, max_devices)
        self.device = self.devices[0]
        self.n_devices = len(self.devices)
        self.model = model.to(self.device, **to_kwargs)
        self.models = [self.model] + [copy.deepcopy(self.model).to(dev, **to_kwargs)
                                      for dev in self.devices[1:]]

    def pad_batch(self, n: int) -> int:
        """Global batch size: requested size rounded up to the device count."""
        return device_batch_size(n, self.devices)

    def put(self, images_u8: np.ndarray):
        """Host -> device copy of a (B, H, W, 3) uint8 batch, or of a
        (B, H*3/2, W) batch on the YUV 4:2:0 wire: pinned and non-blocking on
        CUDA, so it returns before the copy ends. Returns the list of equal
        row blocks, block i on device i (the batch is pinned once)."""
        with hot_stage("engine.put", n=images_u8.nbytes):
            host = torch.from_numpy(np.ascontiguousarray(images_u8))
            if any(dev.type == "cuda" for dev in self.devices):
                with hot_stage("put.pin"):
                    host = host.pin_memory()
            if host.shape[0] % self.n_devices:
                raise ValueError(f"a batch of {host.shape[0]} does not split over"
                                 f" {self.n_devices} devices; pad it to pad_batch()")
            blocks = host.split(host.shape[0] // self.n_devices)
            with hot_stage("put.copy"):
                return [blk.to(dev, non_blocking=True) for blk, dev in zip(blocks, self.devices)]

    def dispatch(self, images):
        """Enqueue the step and return its result on the first device
        without synchronising, so the next batch's decode and copy overlap
        this batch's compute."""
        with hot_stage("engine.dispatch"):
            outs = []
            for i, (dev, block) in enumerate(zip(self.devices, images)):
                with on_device(dev), hot_stage("engine.step", n=len(block), device=dev):
                    outs.append(self._step(block, i))
            return _gather(outs, self.device)


class ClassifierEngine(Replicated):
    """(preprocess -> forward -> probs) step, one replica per device.

    Parity mode (the default) computes in float32 with TF32 off for both
    matmuls and cuDNN convolutions, since cuDNN's default TF32 convolutions
    break the 1e-3 probability budget. Its resize is the exact PIL
    fixed-point one (float64 accumulation).

    ``mixed_precision`` runs the model in bfloat16 under autocast and the
    float32-weight resize, on the K1 kernel, which writes bfloat16.

    WSINSIGHT_PRECISION="default" allows TF32 for the float32 matmuls and
    convolutions (parity's within 0.01); the flags are set around each step
    only (``tf32_flags``), so another engine in the process keeps its own.

    K1 (``ops/fused_preprocess``) is on by default wherever its float32
    resize already is the contract (mixed precision);
    ``WSINSIGHT_PALLAS_PREPROCESS=1`` forces it for parity too (<= 1 uint8
    level of resize drift) and ``=0`` disables it everywhere, as in the JAX
    engine.

    ``w_est`` and ``w_def`` (numpy (3, 3) float32, both or neither) turn on
    stain normalization; they live on every device as tensors of the step,
    so ``set_stains`` swaps them per slide without rebuilding anything.

    The devices are ``parallel.mesh.resolve_devices``'s: every visible card
    by default, cut to ``max_devices``; ``device`` names one, ``devices`` a
    list. Each holds a replica (``Replicated``); the probabilities come back
    in row order on the first device.
    """

    def __init__(
        self,
        model_info: ModelHandle,
        mixed_precision: bool = False,
        w_est: np.ndarray | None = None,
        w_def: np.ndarray | None = None,
        max_devices: int | None = None,
        device: str | torch.device | None = None,
        devices: list[str | torch.device] | None = None,
    ):
        self.allow_tf32 = precision_allows_tf32()
        cfg = model_info.config
        compute_dtype = torch.bfloat16 if mixed_precision else torch.float32

        model = create_model(cfg.architecture, cfg.num_classes, dtype=compute_dtype)
        model.load_state_dict(model_info.load_state_dict(model), strict=True)
        self._place(model, devices, device, max_devices, memory_format=torch.channels_last)

        self.spec = TransformSpec.from_config(cfg.transform)
        if mixed_precision:
            # Speed mode: the float32-weight resize (<= 1 uint8 level of drift).
            self.spec = dataclasses.replace(self.spec, exact_resize=False)
        preprocess = make_preprocess_fn(self.spec, compute_dtype)
        fused_env = os.getenv("WSINSIGHT_PALLAS_PREPROCESS", "")
        use_fused = fused_env != "0" if fused_env else not self.spec.exact_resize
        if use_fused:
            fused = make_fused_preprocess_fn(self.spec, out_dtype=compute_dtype)
            if fused is not None:
                preprocess = fused
        self._preprocess = preprocess

        self._use_stain = w_est is not None and w_def is not None
        self._stains: list = [None] * self.n_devices
        if self._use_stain:
            self.set_stains(w_est, w_def)

    def set_stains(self, w_est: np.ndarray, w_def: np.ndarray) -> None:
        """Swap the per-slide Macenko matrices on every device; nothing is
        rebuilt."""
        if not self._use_stain:
            raise ValueError("engine was built without stain normalization")
        self._stains = [tuple(torch.as_tensor(np.asarray(w, np.float32), device=dev)
                              for w in (w_est, w_def)) for dev in self.devices]

    def _step(self, batch_u8: torch.Tensor, replica: int = 0) -> torch.Tensor:
        with torch.inference_mode(), tf32_flags(self.allow_tf32):
            # A rank-3 batch is the planar YUV 4:2:0 wire (B, H*3/2, W),
            # rebuilt here; the rank says which format came, so a source that
            # stayed on RGB (odd sizes) works too.
            x = yuv420_to_rgb(batch_u8) if batch_u8.dim() == 3 else batch_u8
            if self._use_stain:
                x = deconvolution_based_normalization(x.to(torch.float32) + EPSILON,
                                                      *self._stains[replica])
                # The reference round-trips through uint8 PIL (data.py:300).
                x = torch.clamp(torch.round(x), 0.0, 255.0)
            with hot_stage("classify.preprocess", device=x.device):
                x = self._preprocess(x.to(torch.uint8))  # (B, oh, ow, 3) NHWC
            # NHWC permuted to NCHW is channels_last, without a copy.
            logits = self.models[replica](x.permute(0, 3, 1, 2))
            if logits.dim() > 1 and logits.shape[1] > 1:
                return torch.softmax(logits, dim=1)
            return torch.sigmoid(logits[:, 0])[:, None]

    def run_batch(self, images_u8: np.ndarray, n_valid: int) -> np.ndarray:
        return self.dispatch(self.put(images_u8)).cpu().numpy()[:n_valid]


def classify_slide(
    engine: ClassifierEngine, src: PatchBatchSource, it: Iterator[Batch] | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """One slide's patches through ``engine``: ((N, 4) coords, (N, K) probs)
    in the source's order.

    Two-deep window: batch i+1 is dispatched before batch i's probabilities
    are fetched, and ``device_prefetch`` issues each ``put`` two batches
    ahead, so decode, copy and compute overlap. ``it`` is an iterator of
    ``src`` already started (the cross-slide prefetch's)."""
    slide_coords: list[np.ndarray] = []
    slide_probs: list[np.ndarray] = []
    pending: deque = deque()

    def drain() -> None:
        out, n_valid, coords = pending.popleft()
        with hot_stage("classify.fetch"):
            slide_probs.append(out.cpu().numpy()[:n_valid])
        slide_coords.append(coords[:n_valid])
        qbar.update(1)

    with tqdm.tqdm(total=src.num_batches, position=1, leave=False) as qbar:
        for batch in src.device_prefetch(engine.put, depth=2, it=it):
            pending.append((engine.dispatch(batch.images), batch.n_valid, batch.coords))
            if len(pending) > 2:
                drain()
        while pending:
            drain()
    return np.concatenate(slide_coords, axis=0), np.concatenate(slide_probs, axis=0)


def write_slide_csv(
    path: URIPath, coords: np.ndarray, probs: np.ndarray, class_names,
    parent: pd.Series | None = None, references_dir: str | URIPath | None = None,
) -> None:
    """The model-output CSV of one slide: minx,miny,width,height,prob_<class>...
    (reference: run_inference.py:568-607), then ``qupath_detection_parent``
    (the QuPath TSV's ``Parent`` column) where ``parent`` is given, and the
    references overlay's ``annot_prob_*`` columns where ``references_dir``
    is."""
    slide_df = pd.DataFrame(
        dict(minx=coords[:, 0], miny=coords[:, 1], width=coords[:, 2], height=coords[:, 3])
    )
    slide_df.loc[:, [f"prob_{c}" for c in class_names]] = probs
    if parent is not None:
        slide_df.loc[:, "qupath_detection_parent"] = parent
    if references_dir is not None:
        _apply_references_overlay(slide_df, URIPath(references_dir), path.name)
    with path.open("w") as fh:
        slide_df.to_csv(fh, index=False)


def _one_hot_probs(indexer: np.ndarray, n: int, k: int) -> np.ndarray:
    probs = np.zeros((n, k), dtype=np.float32)
    valid = indexer >= 0
    probs[np.nonzero(valid)[0], indexer[valid]] = 1.0
    return probs


def _norm_names(series: pd.Series) -> pd.Series:
    return series.str.strip().str.replace(" ", "_").str.lower()


def _parse_geojson_rows(slide_geojson, qupath_name_as_class: bool):
    """(centroid, class-name, objectType) per polygon feature of a QuPath
    GeoJSON export; multi-part geometries use their first exterior ring."""
    feats = json.loads(slide_geojson.read_text()).get("features", [])
    rows, names, obj_types = [], [], []
    for feat in feats:
        geom = feat.get("geometry") or {}
        props = feat.get("properties") or {}
        coords_list = geom.get("coordinates") or []
        if geom.get("type") == "Polygon" and coords_list:
            ring = np.asarray(coords_list[0], dtype=np.float64)
        elif geom.get("type") == "MultiPolygon" and coords_list:
            ring = np.asarray(coords_list[0][0], dtype=np.float64)
        else:
            continue
        cx, cy = polygon_centroid(ring)
        rows.append((cx, cy))
        cls = props.get("classification")
        names.append(
            props.get("name")
            if qupath_name_as_class
            else (cls.get("name") if isinstance(cls, dict) else cls)
        )
        obj_types.append(props.get("objectType", ""))
    return rows, names, obj_types


def _centroid_boxes(centers: np.ndarray, mpp: float, patch_size: int) -> np.ndarray:
    """(N, 4) boxes of ``patch_size`` px centred on µm centroids."""
    half = round(patch_size / 2)
    x = np.rint(centers[:, 0] / mpp - half).astype(np.int32)
    y = np.rint(centers[:, 1] / mpp - half).astype(np.int32)
    return np.column_stack([x, y, np.full_like(x, patch_size), np.full_like(y, patch_size)])


def _qupath_tsv_rows(slide_det: URIPath, mpp: float, cfg, name_as_class: bool):
    """QuPath TSV pseudo-model (reference: run_inference.py:318-357): one
    one-hot row per detection, and the TSV's ``Parent`` column."""
    qpdet_df = pd.read_csv(slide_det.materialize(), delimiter="\t")
    centers = qpdet_df[["Centroid X µm", "Centroid Y µm"]].to_numpy(np.float64)
    coords_arr = _centroid_boxes(centers, mpp, cfg.patch_size_pixels)
    det_mask = (qpdet_df["Object type"] == "Detection") | (qpdet_df["Object type"] == "Cell")
    col = "Name" if name_as_class else "Classification"
    # Index over ALL rows, masking non-detections to -1, so probs stay
    # row-aligned with coords. The reference indexes the det_mask SUBSET but
    # scatters its positions into the full-length probs
    # (run_inference.py:342-353), shifting every class one row up past a
    # non-Detection row; that corruption is not reproduced.
    indexer = pd.Index(cfg.class_names).get_indexer(_norm_names(qpdet_df[col]))
    indexer = np.where(det_mask.to_numpy(), indexer, -1)
    probs_arr = _one_hot_probs(indexer, len(qpdet_df), len(cfg.class_names))
    return coords_arr, probs_arr, qpdet_df["Parent"]


def _qupath_geojson_rows(slide_geojson: URIPath, mpp: float, cfg, name_as_class: bool,
                         object_types: tuple[str, ...]):
    """QuPath GeoJSON pseudo-model (reference: run_inference.py:359-416):
    one one-hot row per polygon feature, kept where its ``objectType`` is one
    of ``object_types``. None when the file has no polygon."""
    rows, names, obj_types = _parse_geojson_rows(slide_geojson, name_as_class)
    if not rows:
        return None
    coords_arr = _centroid_boxes(np.asarray(rows), mpp, cfg.patch_size_pixels)
    name_series = pd.Series([n if n is not None else "" for n in names])
    indexer = pd.Index(cfg.class_names).get_indexer(_norm_names(name_series))
    indexer = np.where(np.isin(np.array(obj_types), object_types), indexer, -1)
    return coords_arr, _one_hot_probs(indexer, len(rows), len(cfg.class_names))


def _apply_references_overlay(
    slide_df: pd.DataFrame, references_dir: URIPath, slide_csv_name: str
) -> None:
    """Point-in-box overlay of a prior run's tile CSV onto per-cell rows.

    Chunked, vectorized containment + largest-area tie-break (reference:
    run_inference.py:613-729). Unlike the reference, whose value-fill lines
    were commented out, leaving annot_prob_* always NaN (SURVEY.md §2.11),
    the matched tile probabilities are written.
    """
    annot_csv = references_dir / "model-outputs-csv" / slide_csv_name
    annot_df = pd.read_csv(
        annot_csv.materialize() if isinstance(annot_csv, URIPath) else annot_csv,
        engine="c",
        low_memory=False,
    )
    cx = (slide_df["minx"] + slide_df["width"] * 0.5).to_numpy()
    cy = (slide_df["miny"] + slide_df["height"] * 0.5).to_numpy()

    ax0 = annot_df["minx"].to_numpy()
    ay0 = annot_df["miny"].to_numpy()
    ax1 = (annot_df["minx"] + annot_df["width"]).to_numpy()
    ay1 = (annot_df["miny"] + annot_df["height"]).to_numpy()
    area = (annot_df["width"] * annot_df["height"]).to_numpy()
    prob_cols = [c for c in annot_df.columns if c.startswith("prob_")]
    probs_mat = annot_df[prob_cols].to_numpy(dtype=np.float32)

    n_points = len(slide_df)
    for c in prob_cols:
        slide_df["annot_prob_" + c] = np.nan

    chunk = max(1000, min(200_000 // max(1, len(annot_df) // 1000 + 1), n_points or 1))
    for s in range(0, n_points, chunk):
        e = min(n_points, s + chunk)
        mask = (
            (cx[s:e, None] >= ax0[None, :])
            & (cx[s:e, None] <= ax1[None, :])
            & (cy[s:e, None] >= ay0[None, :])
            & (cy[s:e, None] <= ay1[None, :])
        )
        has_hit = mask.any(axis=1)
        cand = np.where(mask, area[None, :], -np.inf)
        best = cand.argmax(axis=1)
        for j, c in enumerate(prob_cols):
            vals = np.full(e - s, np.nan, dtype=np.float32)
            vals[has_hit] = probs_mat[best[has_hit], j]
            slide_df.loc[slide_df.index[s:e], "annot_prob_" + c] = vals


def run_inference(
    wsi_dir: URIPath | None,
    slide_paths: List[URIPath] | None,
    results_dir: URIPath,
    references_dir: str | URIPath | None = None,
    qupath_detection_dir: str | URIPath | None = None,
    qupath_geojson_detection_dir: str | URIPath | None = None,
    qupath_geojson_annotation_dir: str | URIPath | None = None,
    qupath_name_as_class: bool = False,
    model_info: ModelHandle | None = None,
    halo_size_px: int = 46,
    batch_size: int = 32,
    num_workers: int = 4,
    speedup: bool = False,
    stain_normalization: bool = False,
    object_based: bool = False,
    object_detection: str | None = None,
    mixed_precision: bool = False,
    stitch_workers: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[list[str], list[str]]:
    """Run batched inference on precomputed patches; emit per-slide CSVs.

    Returns (failed_patching, failed_inference) slide-stem lists
    (reference: run_inference.py:45-105). ``device`` follows
    ``parallel.mesh.resolve_device``: the card unless the caller asks for
    the CPU. With a QuPath directory the rows come from QuPath's detections
    or annotations (``model_info`` is then a pseudo-model, as
    ``cli._options.qupath_pseudo_model`` builds): no engine is built and no
    device is touched."""
    # `speedup` is the CLI's name for the bf16 fast path; API callers get the
    # same semantics the CLI pre-folds (JAX package: cli/infer.py:255).
    mixed_precision = mixed_precision or speedup

    if wsi_dir:
        if not wsi_dir.exists():
            raise errors.WholeSlideImageDirectoryNotFound(f"directory not found: {wsi_dir}")
        _validate_wsi_directory(wsi_dir)
    if not results_dir.exists():
        raise errors.ResultsDirectoryNotFound(str(results_dir))

    patch_dir = results_dir / "patches"
    if not patch_dir.exists():
        raise errors.PatchDirectoryNotFound(
            "The 'patches' directory was not found in results directory. This can"
            " happen for a few reasons: 1) no tissue was detected in the slides,"
            " 2) the physical spacing (MPP) could not be read from any of the"
            " slides, or 3) something else... Please read the logs above for"
            " potential errors."
        )
    patch_paths = [p for p in patch_dir.iterdir() if p.is_file()]
    if slide_paths:
        stems = {s.stem for s in slide_paths}
        patch_paths = [p for p in patch_paths if p.stem in stems]

    # Multi-host fan-out: shard slides round-robin across processes (per-slide
    # sharding; no collectives needed).
    if maybe_initialize_distributed():
        patch_paths = shard_slides_for_host(sorted(patch_paths))

    model_output_dir = results_dir / "model-outputs-csv"
    model_output_dir.mkdir(exist_ok=True)

    failed_patching = [p.stem for p in patch_paths if not p.exists()]
    failed_inference: list[str] = []
    engine: ClassifierEngine | None = None
    cells = object_based and object_detection == "end2end"
    cell_engine = None
    # QuPath pseudo-model modes, in the JAX function's order: TSV and GeoJSON
    # detections (object-based, alone), then GeoJSON annotations.
    pseudo = None
    if object_based and qupath_detection_dir is not None and not (
        qupath_geojson_detection_dir or qupath_geojson_annotation_dir
    ):
        pseudo = "tsv"
    elif object_based and qupath_geojson_detection_dir is not None and not (
        qupath_detection_dir or qupath_geojson_annotation_dir
    ):
        pseudo = "geojson"
    elif qupath_geojson_annotation_dir is not None:
        pseudo = "annotation"
    # The references overlay fills annot_prob_* on object-based rows.
    overlay_dir = references_dir if object_based else None

    # Cross-slide overlap: while slide i drains, a background thread opens
    # slide i+1's patch source and STARTS its decode producer, so the first
    # batches are already in the prefetch queue when its turn comes (the
    # reference pays a cold DataLoader spin-up per slide instead,
    # run_inference.py:288-299).
    prefetch_lock = threading.Lock()
    prefetched: dict[str, tuple] = {}

    def spawn_source_prefetch(next_patch_path, host_resize, wire) -> None:
        def work():
            src = None
            try:
                nxt_wsi, use_imgs = _slide_attrs(next_patch_path)
                if (model_output_dir / nxt_wsi.with_suffix(".csv").name).exists():
                    return
                src = PatchBatchSource(
                    wsi_path=nxt_wsi,
                    patch_path=next_patch_path,
                    use_hdf5_images=use_imgs,
                    batch_size=engine.pad_batch(batch_size),
                    num_threads=governed_workers(num_workers or 4),
                    host_resize=host_resize,
                    wire=wire,
                )
                it = iter(src)  # starts the producer thread
                with prefetch_lock:
                    prefetched[str(next_patch_path)] = (src, it)
            except Exception:
                # the slide's own turn opens it again and reports the error
                if src is not None:
                    src.close()

        threading.Thread(target=work, daemon=True).start()

    with maybe_trace("inference"), tqdm.tqdm(
        total=len(patch_paths), desc="Images", position=0
    ) as pbar:
        for slide_idx, patch_path in enumerate(patch_paths):
            wsi_path, use_hdf5_images = _slide_attrs(patch_path)
            slide_csv = model_output_dir / wsi_path.with_suffix(".csv").name
            if slide_csv.exists():
                print("Output CSV exists... skipping.")
                print(slide_csv)
                pbar.update(1)
                continue

            if pseudo is not None:
                cfg = model_info.config
                mpp = _slide_mpp(patch_path)
                parent = None
                if pseudo == "tsv":
                    slide_det = URIPath(qupath_detection_dir) / wsi_path.with_suffix(".txt").name
                    rows = None
                    if slide_det.exists():
                        try:
                            *rows, parent = _qupath_tsv_rows(slide_det, mpp, cfg,
                                                             qupath_name_as_class)
                        except Exception as err:
                            # one malformed TSV (e.g. no Name column under
                            # --qupath-name-as-class) must not stop the cohort
                            logger.error(f"QuPath TSV parse failed for {wsi_path}",
                                         exc_info=err)
                else:
                    gj_dir = (qupath_geojson_detection_dir if pseudo == "geojson"
                              else qupath_geojson_annotation_dir)
                    slide_gj = URIPath(gj_dir) / wsi_path.with_suffix(".geojson").name
                    # QuPath exports annotations with objectType "annotation";
                    # a missing objectType is accepted for hand-rolled files.
                    kinds = ("detection", "cell") if pseudo == "geojson" else ("annotation", "")
                    rows = (_qupath_geojson_rows(slide_gj, mpp, cfg, qupath_name_as_class, kinds)
                            if slide_gj.exists() else None)
                if rows is None:
                    failed_inference.append(wsi_path.stem)
                elif len(rows[0]):
                    write_slide_csv(slide_csv, *rows, cfg.class_names, parent=parent,
                                    references_dir=overlay_dir)
                pbar.update(1)
                continue

            if cells:
                # CellViT single-cell path (reference: :431-535): one engine
                # for every slide; a slide that fails is logged and listed.
                from .cells import CellEngine

                if cell_engine is None:
                    cell_engine = CellEngine(model_info, mixed_precision=mixed_precision,
                                             device=device)
                if not _run_cell_slide(cell_engine, wsi_path, patch_path, use_hdf5_images,
                                       slide_csv, model_info.config.class_names,
                                       halo_size_px=halo_size_px, batch_size=batch_size,
                                       num_workers=num_workers,
                                       stitch_workers=stitch_workers,
                                       references_dir=overlay_dir):
                    failed_inference.append(wsi_path.stem)
                pbar.update(1)
                continue

            w_est = w_def = None
            if stain_normalization:
                # Macenko matrices of this slide, from one shuffled sample
                # batch on the exact RGB wire (reference: :232-266).
                try:
                    sample_src = PatchBatchSource(
                        wsi_path=wsi_path,
                        patch_path=patch_path,
                        use_hdf5_images=use_hdf5_images,
                        batch_size=256,
                        num_threads=governed_workers(num_workers or 4),
                        shuffle_seed=0,
                    )
                    try:
                        sample = next(iter(sample_src))
                    finally:
                        sample_src.close()
                    w_est = estimate_stains_from_batch(
                        sample.images[: sample.n_valid], device=resolve_device(device))
                    w_def = default_target_stains()
                except Exception as err:
                    logger.error(f"stain estimation failed for {wsi_path}", exc_info=err)
                    failed_inference.append(wsi_path.stem)
                    pbar.update(1)
                    continue

            if engine is None:
                engine = ClassifierEngine(
                    model_info, mixed_precision=mixed_precision, w_est=w_est, w_def=w_def,
                    device=device,
                )
            elif stain_normalization:
                engine.set_stains(w_est, w_def)
            # WSINSIGHT_HOST_RESIZE=1 moves the (downscaling) resize into the
            # decode threads, to cut host->device bytes on hosts with a thin
            # link. The device's exact resize is PIL's, so parity
            # probabilities do not change. Not under stain normalization,
            # which must see the patch before the resize (reference order:
            # decode -> stain -> transform).
            host_resize = None
            if (
                os.getenv("WSINSIGHT_HOST_RESIZE", "0") not in ("0", "")
                and not stain_normalization
                and engine.spec.size is not None
            ):
                host_resize = engine.spec.size
            # WSINSIGHT_WIRE=yuv420: ship patches as planar YUV 4:2:0 (1.5
            # B/px) and rebuild RGB on the device. Opt-in (chroma is lossy);
            # the stain sample above always reads the exact RGB wire.
            wire = "yuv420" if os.getenv("WSINSIGHT_WIRE", "").lower() == "yuv420" else None
            with prefetch_lock:
                pre = prefetched.pop(str(patch_path), None)
            src_iter = None
            if pre is not None:
                src, src_iter = pre
            else:
                try:
                    src = PatchBatchSource(
                        wsi_path=wsi_path,
                        patch_path=patch_path,
                        use_hdf5_images=use_hdf5_images,
                        batch_size=engine.pad_batch(batch_size),
                        num_threads=governed_workers(num_workers or 4),
                        host_resize=host_resize,
                        wire=wire,
                    )
                except Exception as err:
                    logger.error(f"could not open patches for {wsi_path}", exc_info=err)
                    failed_inference.append(wsi_path.stem)
                    pbar.update(1)
                    continue
            # overlap: start the NEXT slide's source while this one runs
            # (not under stain normalization: each slide samples its stains
            # first)
            if not object_based and not stain_normalization and slide_idx + 1 < len(patch_paths):
                spawn_source_prefetch(patch_paths[slide_idx + 1], host_resize, wire)

            try:
                coords_arr, probs_arr = classify_slide(engine, src, src_iter)
            finally:
                src.close()
            if len(coords_arr):
                write_slide_csv(slide_csv, coords_arr, probs_arr,
                                model_info.config.class_names)
            pbar.update(1)

    # Close any lookahead sources whose slide was skipped/failed after the
    # prefetch was issued (their producer threads park on the bounded queue).
    with prefetch_lock:
        for leftover_src, _ in prefetched.values():
            leftover_src.close()
        prefetched.clear()

    return failed_patching, failed_inference


def _run_cell_slide(engine, wsi_path, patch_path, use_hdf5_images, slide_csv, class_names,
                    references_dir=None, **run_opts) -> bool:
    """One slide through ``run_cell_inference``: its instances' polygons into
    the patch file's ``/polygons`` group, one CSV row per instance (with the
    references overlay from ``references_dir``). False (logged) when the
    slide's inference fails."""
    import h5py

    from .cells import run_cell_inference
    from ..patchlib.io import write_polygons_group

    local = patch_path.materialize() if isinstance(patch_path, URIPath) else patch_path
    with h5py.File(local, "r") as f:
        g = f["/slide"]
        geometry = dict(mpp=float(g.attrs["slide_mpp"]),
                        slide_width=int(g.attrs["slide_width"]),
                        slide_height=int(g.attrs["slide_height"]))
    try:
        coords_arr, probs_arr, polys = run_cell_inference(
            engine, wsi_path=wsi_path, patch_path=patch_path,
            use_hdf5_images=use_hdf5_images, **geometry, **run_opts)
    except Exception as err:
        logger.error(f"cell inference failed for {wsi_path}", exc_info=err)
        return False
    if polys:
        with patch_path.open("rb+" if patch_path.exists() else "wb+") as fh:
            with h5py.File(fh, "a") as f:
                write_polygons_group(f, polys, f["/coords"].compression)
    if len(coords_arr):
        write_slide_csv(slide_csv, coords_arr, probs_arr, class_names,
                        references_dir=references_dir)
    return True


def _slide_mpp(patch_path) -> float:
    """The slide's microns per pixel, from its patch file."""
    import h5py

    local = patch_path.materialize() if isinstance(patch_path, URIPath) else patch_path
    with h5py.File(local, "r") as f:
        return float(f["/slide"].attrs["slide_mpp"])


def _slide_attrs(patch_path) -> tuple[URIPath, bool]:
    """(slide path, whether the patch file caches /images) of a patch file."""
    import h5py

    local = patch_path.materialize() if isinstance(patch_path, URIPath) else patch_path
    with h5py.File(local, "r") as f:
        return URIPath(f["/slide"].attrs["slide_path"]), "/images" in f
