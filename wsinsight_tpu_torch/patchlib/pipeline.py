"""Segmentation + patch-planning pipeline for directories of slides.

Covers the reference orchestrator's capability surface (reference:
wsinsight/patchlib/pipeline.py:45-508) with a planner-registry design of our
own: every coordinate-planning mode is a small function returning a
:class:`PatchPlan`, and :func:`segment_and_patch_one_slide` is just
resume-check -> :func:`plan_slide` (segment -> polygonize -> plan) -> persist.
``plan_slide`` keeps the plan in memory, so a caller without h5py can plan a
slide with the very code the CLI runs. The five modes:

1. QuPath TSV detections -> centroid boxes (reference: pipeline.py:170-205)
2. QuPath GeoJSON detections -> centroids + polygons (reference: :207-259)
3. end2end cell models -> halo-overlapped grid (reference: :261-297)
4. StarDist pre-detection (reference: :299-355)
5. default tissue grid with per-tile polygons + tile_dim (reference: :357-402)

The port has all five; mode 4 runs the port's StarDist
(``models/stardist.py``) on the card unless the CPU is asked for.

Also fixes a latent reference defect: the patch stage writes
``results_dir/wsi_list.csv``, which downstream QuPath pseudo-model branches
read but nothing in the reference produces (SURVEY.md §2.11).
"""

from __future__ import annotations

import contextlib
import json
import logging
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import numpy.typing as npt
import pandas as pd
from PIL import Image

from ..geometry import polygon_centroid
from ..uri_path import URIPath
from ..utils.profiling import hot_stage
from ..wsi import _validate_wsi_directory, get_avg_mpp, get_wsi_cls
from .io import draw_contours_on_thumbnail, extract_patches_from_slide, save_hdf5
from .patch import (
    get_multipolygon_from_binary_arr,
    get_object_coordinates_within_polygon,
    get_patch_coordinates_within_polygon,
)
from .segment import segment_tissue

logger = logging.getLogger(__name__)

MASKS_DIR = "masks"
PATCHES_DIR = "patches"


@dataclass
class PatchPlan:
    """What a planning mode produces: everything save_hdf5 needs."""

    coords: npt.NDArray[np.int32]
    polygons: Optional[List[np.ndarray]] = None
    tile_dim: Optional[npt.NDArray[np.int32]] = None
    patch_size: int = 0


@dataclass
class _SlideContext:
    """Per-slide planning inputs shared by every mode."""

    slide: object
    slide_path: URIPath
    mpp: float
    patch_size: int  # slide-space pixels: round(px * spacing / mpp)
    polygon: object  # tissue multipolygon (own geometry engine)
    opts: dict = field(default_factory=dict)

    @property
    def dims(self) -> tuple[int, int]:
        return self.slide.dimensions


def _grid_tile_dim(width: int, height: int, half: int, step: int) -> npt.NDArray[np.int32]:
    """Lattice extents of the centroid grid (reference: pipeline.py:283-294
    computes max((centroid-half)/step)+1, which equals the lattice lengths)."""
    nx = len(range(half, width, step))
    ny = len(range(half, height, step))
    return np.asarray([nx, ny], dtype=np.int32)


def _closed_square(x: float, y: float, side: float) -> np.ndarray:
    """Axis-aligned closed ring with top-left (x, y), CCW in image coords."""
    return np.asarray(
        [[x, y], [x, y + side], [x + side, y + side], [x + side, y], [x, y]],
        dtype=np.float32,
    )


def _load_geojson_features(path: URIPath) -> list[dict]:
    data = json.loads(URIPath(path).read_text())
    kind = data.get("type")
    if kind == "FeatureCollection":
        return data.get("features", [])
    return [data] if kind == "Feature" else []


def _exterior_rings(geom: dict) -> list[np.ndarray]:
    """Exterior rings of a GeoJSON Polygon/MultiPolygon as float32 arrays."""
    kind = geom.get("type")
    shells = []
    if kind == "Polygon":
        shells = [geom.get("coordinates") or []]
    elif kind == "MultiPolygon":
        shells = geom.get("coordinates") or []
    return [np.asarray(s[0], dtype=np.float32) for s in shells if s]


# ---------------------------------------------------------------------------
# Planning modes
# ---------------------------------------------------------------------------


def _plan_qupath_tsv(ctx: _SlideContext) -> Optional[PatchPlan]:
    """Mode 1: QuPath TSV detections -> fixed-size boxes around centroids
    (reference: pipeline.py:170-205). Patch size stays in MODEL pixels."""
    patch_size = ctx.opts["patch_size_px"]
    half = round(patch_size / 2)
    det_file = URIPath(ctx.opts["qupath_detection_dir"]) / f"{ctx.slide_path.stem}.txt"
    if not det_file.exists():
        logger.info(f"Skipping because detection file not found: {det_file}")
        return PatchPlan(np.zeros((0, 2), np.int32), patch_size=patch_size)

    table = pd.read_csv(det_file.materialize(), delimiter="\t")
    xs = np.rint(table["Centroid X µm"] / ctx.mpp - half).astype(np.int32)
    ys = np.rint(table["Centroid Y µm"] / ctx.mpp - half).astype(np.int32)
    # Ring = the patch extent [x, x+2h) around the centroid. The reference
    # re-subtracts half from the already-top-left x/y (pipeline.py:195-203),
    # shifting every polygon half a patch off its own box — a
    # self-inconsistent-output defect we deliberately do not reproduce
    # (SURVEY.md §2.11 spirit).
    rings = [_closed_square(x, y, 2 * half) for x, y in zip(xs, ys)]
    return PatchPlan(np.column_stack([xs, ys]), polygons=rings, patch_size=patch_size)


def _plan_qupath_geojson(ctx: _SlideContext) -> Optional[PatchPlan]:
    """Mode 2: QuPath GeoJSON detections -> centroids + native-unit rings
    (reference: pipeline.py:207-259). Reference parity: centroids convert to
    pixels but rings stay in the GeoJSON's units, and multi-part geometries
    are exploded — /polygons rows do NOT pair 1:1 with /coords rows here;
    the only consumer of this mode (references-dir overlay) reads coords."""
    patch_size = ctx.opts["patch_size_px"]
    half = round(patch_size / 2)
    gj_file = URIPath(ctx.opts["qupath_geojson_detection_dir"]) / (
        ctx.slide_path.stem + ".geojson"
    )
    if not gj_file.exists():
        logger.info(f"Skipping because geojson file not found: {gj_file}")
        return PatchPlan(np.zeros((0, 2), np.int32), patch_size=patch_size)

    centers: list[tuple[float, float]] = []
    rings: list[np.ndarray] = []
    for feature in _load_geojson_features(gj_file):
        shells = _exterior_rings(feature.get("geometry") or {})
        if shells:
            # centroid of the first exterior shell, like geopandas' centroid
            # of the (exploded) geometry upstream
            centers.append(polygon_centroid(shells[0].astype(np.float64)))
            rings.extend(shells)
    if not rings:
        return None
    um = np.asarray(centers, dtype=np.float64)
    coords = np.rint(um / ctx.mpp - half).astype(np.int32)
    return PatchPlan(coords, polygons=rings, patch_size=patch_size)


def _plan_halo_grid(ctx: _SlideContext) -> Optional[PatchPlan]:
    """Mode 3: end2end cell models — tissue grid whose overlap equals twice
    the model halo so detection cores tile seamlessly (reference: :261-297).
    At 256 px with a 46 px halo the step is 164 px."""
    width, height = ctx.dims
    half = round(ctx.patch_size / 2)
    overlap = 2 * ctx.opts["halo_size_px"] / ctx.opts["patch_size_px"]
    coords = get_patch_coordinates_within_polygon(
        slide_width=width, slide_height=height,
        patch_size=ctx.patch_size, half_patch_size=half,
        polygon=ctx.polygon, overlap=overlap,
    )
    step = round((1 - overlap) * ctx.patch_size)
    logger.info(f"{len(coords)} patches land inside tissue")
    return PatchPlan(
        coords, tile_dim=_grid_tile_dim(width, height, half, step),
        patch_size=ctx.patch_size,
    )


def _plan_stardist(ctx: _SlideContext) -> Optional[PatchPlan]:
    """Mode 4: StarDist nucleus pre-detection over the whole image
    (reference: :299-355), served by the port's StarDist
    (``models/stardist.py``, on the card unless the CPU is asked for)."""
    from ..models.stardist import predict_nuclei_big

    slide = ctx.slide
    # read_region_array is TpuSlide-only; foreign backends return PIL
    # (same capability probe as patchlib/io.py and engine/data.py).
    grab = getattr(slide, "read_region_array", None)
    with hot_stage("stardist.read"):
        if grab is not None:
            image = grab((0, 0), 0, slide.dimensions)
        else:
            image = np.asarray(slide.read_region((0, 0), 0, slide.dimensions))[:, :, :3]

    nuclei = predict_nuclei_big(
        image,
        pmin=ctx.opts["stardist_normalization_pmin"],
        pmax=ctx.opts["stardist_normalization_pmax"],
    )
    centroids = np.zeros((len(nuclei), 2), dtype=np.int32)
    rings: list[np.ndarray] = []
    for n, outline in enumerate(nuclei):
        if len(outline) and not np.allclose(outline[0], outline[-1]):
            outline = np.vstack([outline, outline[:1]])
        rings.append(outline.astype(np.float32))
        centroids[n] = np.rint(polygon_centroid(outline.astype(np.float64)))

    coords = get_object_coordinates_within_polygon(
        object_centroids_arr=centroids,
        half_patch_size=int(round(ctx.patch_size / 2)),
        polygon=ctx.polygon,
    )
    return PatchPlan(coords, polygons=rings, patch_size=ctx.patch_size)


def _plan_tissue_grid(ctx: _SlideContext) -> Optional[PatchPlan]:
    """Mode 5 (default): regular grid over the tissue polygon, one closed
    inclusive-extent ring per tile (reference: :357-402)."""
    width, height = ctx.dims
    half = round(ctx.patch_size / 2)
    overlap = ctx.opts["overlap"]
    coords = get_patch_coordinates_within_polygon(
        slide_width=width, slide_height=height,
        patch_size=ctx.patch_size, half_patch_size=half,
        polygon=ctx.polygon, overlap=overlap,
    )
    step = round((1 - overlap) * ctx.patch_size)
    # Inclusive pixel extents ([min, min+size-1]) — the reference's tile ring
    # convention, consumed by the OME-CSV/GeoJSON polygon paths.
    rings = [_closed_square(x, y, ctx.patch_size - 1) for x, y in coords]
    logger.info(f"{len(coords)} patches land inside tissue")
    return PatchPlan(
        coords, polygons=rings,
        tile_dim=_grid_tile_dim(width, height, half, step),
        patch_size=ctx.patch_size,
    )


def _select_planner(opts: dict):
    """Mode dispatch on (object_based, qupath dirs, object_detection) — the
    same decision table as reference pipeline.py:170-402."""
    if not opts["object_based"]:
        return _plan_tissue_grid
    has_tsv = opts["qupath_detection_dir"] is not None
    has_gj = opts["qupath_geojson_detection_dir"] is not None
    has_annot = opts["qupath_geojson_annotation_dir"] is not None
    if has_tsv and not has_gj and not has_annot:
        return _plan_qupath_tsv
    if has_gj and not has_tsv and not has_annot:
        return _plan_qupath_geojson
    if has_tsv or has_gj or has_annot:
        return _plan_tissue_grid
    return _plan_halo_grid if opts["object_detection"] == "end2end" else _plan_stardist


# ---------------------------------------------------------------------------
# One slide: plan, then persist
# ---------------------------------------------------------------------------


def _tissue_mask(
    thumb: Image.Image,
    thumbsize: tuple[int, int],
    slide_path: URIPath,
    opts: dict,
) -> np.ndarray:
    """Boolean tissue mask at thumbnail resolution: HistoQC ingestion when a
    mask directory is supplied, else our own segmentation."""
    histoqc_dir = opts["histoqc_dir"]
    if histoqc_dir:
        mask_file = (
            URIPath(histoqc_dir) / slide_path.name / f"{slide_path.name}_mask_use.png"
        )
        mask_img = Image.open(mask_file.materialize())
        ratio = min(t / s for t, s in zip(thumbsize, mask_img.size))
        target = tuple(int(np.round(ratio * s)) for s in mask_img.size)
        return np.array(
            np.asarray(mask_img.resize(target, Image.Resampling.NEAREST)), dtype=bool
        )
    return segment_tissue(
        np.asarray(thumb),
        median_filter_size=opts["median_filter_size"],
        binary_threshold=opts["binary_threshold"],
        closing_kernel_size=opts["closing_kernel_size"],
        min_object_size_px=opts["min_object_size_px"],
        min_hole_size_px=opts["min_hole_size_px"],
    )


def plan_slide(
    slide_path: URIPath,
    qupath_detection_dir: URIPath | None,
    qupath_geojson_detection_dir: URIPath | None,
    qupath_geojson_annotation_dir: URIPath | None,
    patch_size_px: int, patch_spacing_um_px: float, halo_size_px: int = 0,
    histoqc_dir: str | URIPath | None = None,
    thumbsize: tuple[int, int] = (2048, 2048),
    median_filter_size: int = 7, binary_threshold: int = 7,
    closing_kernel_size: int = 6,
    min_object_size_um2: float = 200**2, min_hole_size_um2: float = 190**2,
    overlap: float = 0.0, object_based: bool = False,
    object_detection: str | None = None,
    stardist_normalization_pmin: float = 1.0,
    stardist_normalization_pmax: float = 99.8,
) -> tuple[PatchPlan, _SlideContext, Image.Image, tuple, np.ndarray] | None:
    """Segment one slide's tissue and plan its patch coordinates, in memory.

    Returns ``(plan, ctx, thumb, contours, hierarchy)``, or None when no
    tissue is found or the planner gives no plan. ``ctx.slide`` stays open
    only when a plan is returned; the caller closes it."""
    if len(thumbsize) != 2:
        raise ValueError(f"Length of 'thumbsize' must be 2 but got {len(thumbsize)}")

    with hot_stage("plan_slide") as span, contextlib.ExitStack() as on_failure:
        with hot_stage("plan.open"):
            slide = get_wsi_cls()(slide_path)
            on_failure.callback(slide.close)
            mpp = get_avg_mpp(slide_path)
        logger.info(f"slide WxH={slide.dimensions} mpp={mpp}")

        # Slide-space patch size: round(px * spacing / mpp) (reference: :96).
        patch_size = int(round(patch_size_px * patch_spacing_um_px / mpp))
        logger.info(f"slide-space patch size: {patch_size}")

        with hot_stage("plan.thumbnail"):
            thumb = slide.get_thumbnail(thumbsize)
            if thumb.mode != "RGB":
                thumb = thumb.convert("RGB")

        # Object/hole µm² thresholds become thumbnail-pixel counts via the
        # thumbnail's own MPP (reference: :107-112).
        thumb_mpp = (mpp * (np.array(slide.dimensions) / thumb.size)).mean()
        opts = {
            "patch_size_px": patch_size_px,
            "halo_size_px": halo_size_px,
            "overlap": overlap,
            "object_based": object_based,
            "object_detection": object_detection,
            "qupath_detection_dir": qupath_detection_dir,
            "qupath_geojson_detection_dir": qupath_geojson_detection_dir,
            "qupath_geojson_annotation_dir": qupath_geojson_annotation_dir,
            "histoqc_dir": histoqc_dir,
            "median_filter_size": median_filter_size,
            "binary_threshold": binary_threshold,
            "closing_kernel_size": closing_kernel_size,
            "min_object_size_px": round(min_object_size_um2 / thumb_mpp**2),
            "min_hole_size_px": round(min_hole_size_um2 / thumb_mpp**2),
            "stardist_normalization_pmin": stardist_normalization_pmin,
            "stardist_normalization_pmax": stardist_normalization_pmax,
        }

        with hot_stage("plan.tissue_mask"):
            mask = _tissue_mask(thumb, thumbsize, slide_path, opts)
        if not np.issubdtype(mask.dtype, np.bool_):
            raise TypeError(f"expected boolean segmentation array but got {mask.dtype}")

        downscale = tuple(d / t for d, t in zip(slide.dimensions, thumb.size))
        with hot_stage("plan.polygonize"):
            polygonized = get_multipolygon_from_binary_arr(
                mask.astype("uint8") * 255, scale=downscale
            )
        if polygonized is None:
            logger.warning(f"no tissue found in {slide_path}")
            return None
        tissue_polygon, contours, hierarchy = polygonized

        ctx = _SlideContext(
            slide=slide, slide_path=slide_path, mpp=mpp,
            patch_size=patch_size, polygon=tissue_polygon, opts=opts,
        )
        with hot_stage("plan.select"):
            plan = _select_planner(opts)(ctx)
        if plan is None:
            return None
        span.n = len(plan.coords)
        on_failure.pop_all()  # the plan's slide stays open for the caller
        return plan, ctx, thumb, contours, hierarchy


def segment_and_patch_one_slide(
    slide_path: URIPath, save_dir: URIPath,
    qupath_detection_dir: URIPath | None,
    qupath_geojson_detection_dir: URIPath | None,
    qupath_geojson_annotation_dir: URIPath | None,
    patch_size_px: int, patch_spacing_um_px: float, halo_size_px: int = 0,
    *,
    cache_image_patches: bool = False,
    **plan_options,
) -> None:
    """Plan patch coordinates in tissue for one slide and persist them
    (patches/<stem>.h5 + masks/<stem>.jpg — the stage's resume contract).
    ``plan_options`` are :func:`plan_slide`'s keyword arguments."""
    stem = slide_path.stem
    logger.info(f"segment+patch: {slide_path}")

    h5_out = save_dir / PATCHES_DIR / f"{stem}.h5"
    mask_out = save_dir / MASKS_DIR / f"{stem}.jpg"
    if h5_out.exists() and mask_out.exists():
        logger.info("Patch output and mask output files already exist; skipping")
        return None

    planned = plan_slide(
        slide_path, qupath_detection_dir, qupath_geojson_detection_dir,
        qupath_geojson_annotation_dir, patch_size_px, patch_spacing_um_px,
        halo_size_px, **plan_options,
    )
    if planned is None:
        return None
    plan, ctx, thumb, contours, hierarchy = planned
    try:
        _persist_plan(plan, ctx, h5_out, patch_spacing_um_px, cache_image_patches)
    finally:
        ctx.slide.close()

    logger.info(f"Writing tissue thumbnail with contours to disk: {mask_out}")
    mask_out.parent.mkdir(exist_ok=True, parents=True)
    annotated = draw_contours_on_thumbnail(thumb, contours=contours, hierarchy=hierarchy)
    annotated.thumbnail((1024, 1024), resample=Image.Resampling.LANCZOS)
    with mask_out.open("wb") as fh:
        annotated.save(fh, format="JPEG")
    return None


def _persist_plan(
    plan: PatchPlan,
    ctx: _SlideContext,
    h5_out: URIPath,
    patch_spacing_um_px: float,
    cache_image_patches: bool,
) -> None:
    h5_out.parent.mkdir(exist_ok=True, parents=True)
    if plan.coords.size == 0:
        logger.warning(f"No patches found for slide {ctx.slide_path}")
        return
    images = (
        extract_patches_from_slide(ctx.slide, plan.coords, plan.patch_size)
        if cache_image_patches
        else None
    )
    width, height = ctx.dims
    save_hdf5(
        path=h5_out,
        coords=plan.coords,
        polygons=plan.polygons,
        tile_dim=plan.tile_dim,
        patch_size=plan.patch_size,
        patch_spacing_um_px=patch_spacing_um_px,
        compression="gzip",
        images=images,
        slide_path=str(ctx.slide_path),
        slide_mpp=ctx.mpp,
        slide_width=width,
        slide_height=height,
    )


# ---------------------------------------------------------------------------
# A directory of slides
# ---------------------------------------------------------------------------


def segment_and_patch_directory_of_slides(
    wsi_dir: URIPath, slide_paths: List[URIPath], save_dir: URIPath,
    qupath_detection_dir: str | URIPath | None,
    qupath_geojson_detection_dir: str | URIPath | None,
    qupath_geojson_annotation_dir: str | URIPath | None,
    patch_size_px: int, patch_spacing_um_px: float, halo_size_px: int = 0,
    histoqc_dir: str | URIPath | None = None,
    thumbsize: tuple[int, int] = (2048, 2048),
    median_filter_size: int = 7, binary_threshold: int = 7,
    closing_kernel_size: int = 6,
    min_object_size_um2: float = 200**2, min_hole_size_um2: float = 190**2,
    overlap: float = 0.0, object_based: bool = False,
    object_detection: str | None = None,
    stardist_normalization_pmin: float = 1.0,
    stardist_normalization_pmax: float = 99.8,
    cache_image_patches: bool = False,
) -> None:
    """Segment + patch every slide; one bad slide never kills the cohort
    (per-slide try/except, reference: pipeline.py:479-506)."""
    wsi_dir = URIPath(wsi_dir)
    _validate_wsi_directory(wsi_dir)
    _write_wsi_listing(save_dir, slide_paths)

    per_slide = dict(
        save_dir=save_dir,
        qupath_detection_dir=qupath_detection_dir,
        qupath_geojson_detection_dir=qupath_geojson_detection_dir,
        qupath_geojson_annotation_dir=qupath_geojson_annotation_dir,
        patch_size_px=patch_size_px, patch_spacing_um_px=patch_spacing_um_px,
        halo_size_px=halo_size_px, histoqc_dir=histoqc_dir,
        thumbsize=thumbsize, median_filter_size=median_filter_size,
        binary_threshold=binary_threshold,
        closing_kernel_size=closing_kernel_size,
        min_object_size_um2=min_object_size_um2,
        min_hole_size_um2=min_hole_size_um2,
        overlap=overlap, object_based=object_based,
        object_detection=object_detection,
        stardist_normalization_pmin=stardist_normalization_pmin,
        stardist_normalization_pmax=stardist_normalization_pmax,
        cache_image_patches=cache_image_patches,
    )
    total = len(slide_paths)
    for i, slide_path in enumerate(slide_paths, start=1):
        logger.info(f"Slide {i} of {total} ({i / total:.2%})")
        try:
            segment_and_patch_one_slide(slide_path=slide_path, **per_slide)
        except Exception as e:
            logger.error(f"Failed to segment and patch slide\n{slide_path}", exc_info=e)
    return None


def _write_wsi_listing(save_dir: URIPath, slide_paths: List[URIPath]) -> None:
    """wsi_list.csv: the contract downstream QuPath pseudo-model branches read
    (fixes SURVEY.md §2.11 — the reference reads but never writes it)."""
    try:
        listing = pd.DataFrame({"wsi_path": [str(p) for p in slide_paths]})
        with (URIPath(save_dir) / "wsi_list.csv").open("w") as fh:
            listing.to_csv(fh, index=False)
    except Exception as err:  # non-fatal bookkeeping
        logger.warning(f"Could not write wsi_list.csv: {err}")
