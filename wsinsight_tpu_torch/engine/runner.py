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

``run_inference`` has the JAX function's default branch (patch
classification) with its stain normalization, host resize
(WSINSIGHT_HOST_RESIZE) and wire (WSINSIGHT_WIRE) read per slide, its
cross-slide source prefetch, resume and CSV schema
(``minx,miny,width,height,prob_<class>...``), and its end2end cell branch
(``engine/cells.run_cell_inference``: one CSV row per nucleus, the polygons
into the patch file's ``/polygons`` group). Its other branches raise
``NotImplementedError`` naming the ROADMAP.md Queue 1 item they wait for:
the QuPath pseudo-models and the references overlay (item 4). Multi-host
fan-out (item 10) is not ported; each process runs every slide it is given.
"""

from __future__ import annotations

import dataclasses
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
from ..errors import not_ported
from ..models import create_model
from ..ops.fused_preprocess import make_fused_preprocess_fn
from ..ops.preprocess import TransformSpec, make_preprocess_fn, yuv420_to_rgb
from ..ops.stain import (
    EPSILON,
    deconvolution_based_normalization,
    default_target_stains,
    estimate_stains_from_batch,
)
from ..parallel.mesh import pad_to_multiple, resolve_device
from ..uri_path import URIPath
from ..utils.profiling import maybe_trace
from ..utils.workers import governed_workers
from ..wsi import _validate_wsi_directory
from ..zoo import ModelHandle
from .data import Batch, PatchBatchSource

logger = logging.getLogger(__name__)


def _refuse_unported_options() -> None:
    """The option of the JAX engines not ported yet: WSINSIGHT_PRECISION (its
    torch values are not defined yet)."""
    if os.getenv("WSINSIGHT_PRECISION"):
        raise NotImplementedError(not_ported("WSINSIGHT_PRECISION", 5))


class ClassifierEngine:
    """(preprocess -> forward -> probs) step on one device.

    Parity mode (the default) computes in float32 with TF32 off for both
    matmuls and cuDNN convolutions: this constructor sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` for the process, since
    cuDNN's default TF32 convolutions break the 1e-3 probability budget. Its
    resize is the exact PIL fixed-point one (float64 accumulation).

    ``mixed_precision`` runs the model in bfloat16 under autocast and the
    float32-weight resize, on the K1 kernel, which writes bfloat16.

    K1 (``ops/fused_preprocess``) is on by default wherever its float32
    resize already is the contract (mixed precision);
    ``WSINSIGHT_PALLAS_PREPROCESS=1`` forces it for parity too (<= 1 uint8
    level of resize drift) and ``=0`` disables it everywhere, as in the JAX
    engine.

    ``w_est`` and ``w_def`` (numpy (3, 3) float32, both or neither) turn on
    stain normalization; they live on the device as tensors of the step, so
    ``set_stains`` swaps them per slide without rebuilding anything.
    """

    def __init__(
        self,
        model_info: ModelHandle,
        mixed_precision: bool = False,
        w_est: np.ndarray | None = None,
        w_def: np.ndarray | None = None,
        max_devices: int | None = None,
        device: str | torch.device | None = None,
    ):
        _refuse_unported_options()
        self.device = resolve_device(device)
        self.n_devices = 1  # one device in this slice; max_devices has nothing to cut
        cfg = model_info.config
        compute_dtype = torch.bfloat16 if mixed_precision else torch.float32
        if not mixed_precision:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        model = create_model(cfg.architecture, cfg.num_classes, dtype=compute_dtype)
        model.load_state_dict(model_info.load_state_dict(model), strict=True)
        self.model = model.to(self.device, memory_format=torch.channels_last)

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
        self._w_est = self._w_def = None
        if self._use_stain:
            self.set_stains(w_est, w_def)

    def _stain_tensor(self, w: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(w, np.float32), device=self.device)

    def set_stains(self, w_est: np.ndarray, w_def: np.ndarray) -> None:
        """Swap the per-slide Macenko matrices; nothing is rebuilt."""
        if not self._use_stain:
            raise ValueError("engine was built without stain normalization")
        self._w_est = self._stain_tensor(w_est)
        self._w_def = self._stain_tensor(w_def)

    def pad_batch(self, n: int) -> int:
        """Global batch size: requested size rounded up to the device count."""
        return pad_to_multiple(n, self.n_devices)

    def _step(self, batch_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            # A rank-3 batch is the planar YUV 4:2:0 wire (B, H*3/2, W),
            # rebuilt here; the rank says which format came, so a source that
            # stayed on RGB (odd sizes) works too.
            x = yuv420_to_rgb(batch_u8) if batch_u8.dim() == 3 else batch_u8
            if self._use_stain:
                x = deconvolution_based_normalization(x.to(torch.float32) + EPSILON,
                                                      self._w_est, self._w_def)
                # The reference round-trips through uint8 PIL (data.py:300).
                x = torch.clamp(torch.round(x), 0.0, 255.0)
            x = self._preprocess(x.to(torch.uint8))  # (B, oh, ow, 3) NHWC
            # NHWC permuted to NCHW is channels_last, without a copy.
            logits = self.model(x.permute(0, 3, 1, 2))
            if logits.dim() > 1 and logits.shape[1] > 1:
                return torch.softmax(logits, dim=1)
            return torch.sigmoid(logits[:, 0])[:, None]

    def put(self, images_u8: np.ndarray) -> torch.Tensor:
        """Host -> device copy of a (B, H, W, 3) uint8 batch, or of a
        (B, H*3/2, W) batch on the YUV 4:2:0 wire: pinned and non-blocking on
        CUDA, so it returns before the copy ends."""
        host = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def dispatch(self, images: torch.Tensor) -> torch.Tensor:
        """Enqueue the step and return the device tensor of probabilities
        without synchronising, so the next batch's decode and copy overlap
        this batch's compute."""
        return self._step(images)

    def run_batch(self, images_u8: np.ndarray, n_valid: int) -> np.ndarray:
        return self._step(self.put(images_u8)).cpu().numpy()[:n_valid]


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
    path: URIPath, coords: np.ndarray, probs: np.ndarray, class_names
) -> None:
    """The model-output CSV of one slide: minx,miny,width,height,prob_<class>...
    (reference: run_inference.py:568-607)."""
    slide_df = pd.DataFrame(
        dict(minx=coords[:, 0], miny=coords[:, 1], width=coords[:, 2], height=coords[:, 3])
    )
    slide_df.loc[:, [f"prob_{c}" for c in class_names]] = probs
    with path.open("w") as fh:
        slide_df.to_csv(fh, index=False)


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
    the CPU."""
    if qupath_detection_dir or qupath_geojson_detection_dir or qupath_geojson_annotation_dir:
        raise NotImplementedError(not_ported("the QuPath pseudo-models", 4))
    if references_dir is not None and object_based:
        raise NotImplementedError(not_ported("the references overlay", 4))

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

    model_output_dir = results_dir / "model-outputs-csv"
    model_output_dir.mkdir(exist_ok=True)

    failed_patching = [p.stem for p in patch_paths if not p.exists()]
    failed_inference: list[str] = []
    engine: ClassifierEngine | None = None
    cells = object_based and object_detection == "end2end"
    cell_engine = None

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

            if cells:
                # CellViT single-cell path (reference: :431-535): one engine
                # for every slide; a slide that fails is logged and listed.
                from .cells import CellEngine

                if cell_engine is None:
                    cell_engine = CellEngine(model_info, mixed_precision=mixed_precision,
                                             device=device)
                    logger.info(
                        "cells run on the host-canvas engine: the banded streaming engine"
                        " that WSINSIGHT_STREAM_CELLS="
                        f"{os.getenv('WSINSIGHT_STREAM_CELLS', '1')!r} selects in the JAX"
                        " package is not ported (ROADMAP.md, Queue 1, item 6); both give"
                        " the same instances")
                if not _run_cell_slide(cell_engine, wsi_path, patch_path, use_hdf5_images,
                                       slide_csv, model_info.config.class_names,
                                       halo_size_px=halo_size_px, batch_size=batch_size,
                                       num_workers=num_workers,
                                       stitch_workers=stitch_workers):
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
                    **run_opts) -> bool:
    """One slide through ``run_cell_inference``: its instances' polygons into
    the patch file's ``/polygons`` group, one CSV row per instance. False
    (logged) when the slide's inference fails."""
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
        write_slide_csv(slide_csv, coords_arr, probs_arr, class_names)
    return True


def _slide_attrs(patch_path) -> tuple[URIPath, bool]:
    """(slide path, whether the patch file caches /images) of a patch file."""
    import h5py

    local = patch_path.materialize() if isinstance(patch_path, URIPath) else patch_path
    with h5py.File(local, "r") as f:
        return URIPath(f["/slide"].attrs["slide_path"]), "/images" in f
