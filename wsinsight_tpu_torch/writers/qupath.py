"""QuPath project builder pairing model-output CSVs with GeoJSON overlays.

A copy of wsinsight_tpu/writers/qupath.py: the port imports nothing of that package.

Same capability as the reference helper (wsinsight/qupath.py:20-88): walk the
``model-outputs-csv`` directory, pair every CSV stem with its GeoJSON overlay
and source image, and materialize a paquo project under
``results_dir/model-outputs-qupath``. Needs ``paquo`` plus a QuPath install
(point ``PAQUO_QUPATH_DIR`` at it) at runtime; importing this module without
them is fine.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Iterable, Sequence

from ..uri_path import URIPath

logger = logging.getLogger(__name__)

try:
    from paquo.projects import QuPathProject, QuPathProjectImageEntry  # type: ignore
except Exception:  # paquo (or its JVM) missing — report at call time, not import
    QuPathProject = QuPathProjectImageEntry = None

HAS_PAQUO = QuPathProject is not None

_NO_QUPATH_MSG = (
    "QuPath was not found, and it is required for --qupath output.\n"
    "Set PAQUO_QUPATH_DIR to an existing QuPath installation, or install\n"
    "QuPath from https://qupath.github.io/ first."
)


def add_image_and_geojson(qupath_proj, *, image_path, geojson_path) -> None:
    """Register one image plus its GeoJSON annotations into a QuPath project."""
    try:
        features = json.loads(Path(geojson_path).read_text())["features"]
    except (OSError, ValueError, KeyError) as e:
        logger.error("could not read features from %s: %r", geojson_path, e)
        return

    entry = qupath_proj.add_image(image_path)
    if isinstance(entry, QuPathProjectImageEntry):
        try:
            entry.hierarchy.load_geojson(features)
        except Exception as e:
            logger.error("load_geojson failed for %s: %r", image_path, e)
    else:
        logger.error(
            "paquo add_image(%s) returned %s, expected a single image entry",
            image_path,
            type(entry).__name__,
        )


def _pair_outputs(
    results_dir: Path,
    wsi_dir,
    slide_paths: Sequence | None,
) -> Iterable[tuple[Path, Path]]:
    """Yield (image, geojson) pairs for every exported CSV that has both.

    Image lookup prefers the explicit ``slide_paths`` list (any suffix); with
    only ``wsi_dir`` we fall back to the reference's ``<stem>.svs`` convention.
    """
    stem_to_slide = {p.stem: p for p in slide_paths or ()}
    for csv_path in sorted((results_dir / "model-outputs-csv").glob("*.csv")):
        stem = csv_path.stem
        geojson = results_dir / "model-outputs-geojson" / f"{stem}.geojson"
        image = stem_to_slide.get(stem)
        if image is None and wsi_dir is not None:
            image = wsi_dir / f"{stem}.svs"
        if image is not None and image.exists() and geojson.exists():
            yield image, geojson
        else:
            logger.warning("no image/geojson pair for %s; skipping", csv_path.name)


def make_qupath_project(
    wsi_dir: str | URIPath | None,
    results_dir: Path,
    slide_paths=None,
) -> None:
    """Materialize a QuPath project from CSV+GeoJSON outputs.

    With neither ``wsi_dir`` nor ``slide_paths`` there is nothing to pair
    against — fail fast instead of TypeError-ing after the whole pipeline
    already ran (reference defect: ``qupath.py:72`` would crash on None).
    """
    if not HAS_PAQUO:
        print(_NO_QUPATH_MSG)
        sys.exit(1)
    if wsi_dir is None and not slide_paths:
        raise ValueError(
            "make_qupath_project needs wsi_dir or slide_paths to locate images"
        )

    logger.info("building QuPath project under %s", results_dir)
    pairs = list(_pair_outputs(results_dir, wsi_dir, slide_paths))
    with QuPathProject(results_dir / "model-outputs-qupath", mode="w") as project:
        for image, geojson in pairs:
            try:
                add_image_and_geojson(project, image_path=image, geojson_path=geojson)
            except Exception as e:
                logger.error("failed to add %s to the project: %r", image, e)
    logger.info("QuPath project written (%d images)", len(pairs))
