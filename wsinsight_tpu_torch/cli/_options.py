"""Shared click options/helpers for the patch/infer/run commands.

The reference repeats env-configured URIPathType blocks per option (e.g.
cli/run.py:165-308); here they are factored into reusable decorators. Env vars
honored: S3_STORAGE_OPTIONS (JSON fsspec kwargs), WSINSIGHT_REMOTE_CACHE_DIR.

The port's commands take every option of the JAX package's, with the same
names and defaults, the exporters, the analytics and the QuPath
pseudo-models (:func:`qupath_pseudo_model`) among them.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import click

from ..uri_path import URIPath, URIPathType
from ..zoo import ModelConfiguration, ModelHandle, get_registered_model


def _uri_type(exists: bool = False) -> URIPathType:
    cache_dir = os.getenv("WSINSIGHT_REMOTE_CACHE_DIR") or None
    opts_env = os.getenv("S3_STORAGE_OPTIONS")
    storage_options = json.loads(opts_env) if opts_env else None
    return URIPathType(exists=exists, storage_options=storage_options, cache_dir=cache_dir)


def io_options(fn):
    fn = click.option(
        "-i",
        "--wsi-dir",
        type=_uri_type(exists=True),
        required=False,
        default=None,
        help="Directory containing whole slide images (local, s3://, or"
        " gdc-manifest://).",
    )(fn)
    fn = click.option(
        "--slide-path",
        "slide_paths",
        type=_uri_type(exists=True),
        multiple=True,
        default=None,
        help="Explicit slide path(s) to process instead of the whole directory.",
    )(fn)
    fn = click.option(
        "-o",
        "--results-dir",
        type=_uri_type(),
        required=True,
        help="Directory to store patch and model results.",
    )(fn)
    fn = click.option(
        "-r",
        "--references-dir",
        type=_uri_type(),
        default=None,
        help="A prior run's results directory used as annotation reference overlay.",
    )(fn)
    return fn


def qupath_options(fn):
    fn = click.option(
        "--qupath-detection-dir",
        type=_uri_type(),
        default=None,
        help="Directory of QuPath detection TSV files (pseudo-model input).",
    )(fn)
    fn = click.option(
        "--qupath-geojson-detection-dir",
        type=_uri_type(),
        default=None,
        help="Directory of QuPath detection GeoJSON files (pseudo-model input).",
    )(fn)
    fn = click.option(
        "--qupath-geojson-annotation-dir",
        type=_uri_type(),
        default=None,
        help="Directory of QuPath annotation GeoJSON files.",
    )(fn)
    fn = click.option(
        "--qupath-detection-patch-size", type=int, default=56, show_default=True,
        help="Patch size (px) for QuPath detection pseudo-models.",
    )(fn)
    fn = click.option(
        "--qupath-annotation-patch-size", type=int, default=224, show_default=True,
        help="Patch size (px) for QuPath annotation pseudo-models.",
    )(fn)
    fn = click.option(
        "--qupath-spacing-um-px", type=float, default=0.5, show_default=True,
        help="Spacing (um/px) for QuPath pseudo-models.",
    )(fn)
    fn = click.option(
        "--qupath-name-as-class", is_flag=True, default=False, show_default=True,
        help="Use the QuPath object Name column (instead of Classification) as class.",
    )(fn)
    return fn


def model_options(fn):
    fn = click.option(
        "-m",
        "--model",
        "model_name",
        type=str,
        default=None,
        help="Name of a registered model (see the model registry;"
        " WSINFER_ZOO_REGISTRY_PATH overrides).",
    )(fn)
    fn = click.option(
        "-c",
        "--config",
        type=click.Path(exists=True, dir_okay=False, path_type=Path),
        default=None,
        help="Path to a model-config JSON (mutually exclusive with --model).",
    )(fn)
    fn = click.option(
        "-p",
        "--model-path",
        type=click.Path(exists=True, dir_okay=False, path_type=Path),
        default=None,
        help="Path to model weights (flax .msgpack or torch .pt/.ts).",
    )(fn)
    return fn


def patch_geometry_options(fn):
    fn = click.option(
        "--patch-overlap-ratio", type=click.FloatRange(min=0, max=1, max_open=True),
        default=0.0, show_default=True,
        help="Overlap ratio between patches (0 = non-overlapping).",
    )(fn)
    fn = click.option(
        "--patch-size-um", type=click.FloatRange(min=0), default=0.0, show_default=True,
        help="Patch step in micrometers (alternative to overlap).",
    )(fn)
    fn = click.option(
        "--patch-size-px", type=click.FloatRange(min=0), default=0, show_default=True,
        help="Patch step in pixels; 0 uses the model's full patch size.",
    )(fn)
    return fn


def validate_model_args(model_name, config, model_path, qupath_dirs) -> None:
    """Mutual-exclusion validation (reference: cli/patch.py:603-615)."""
    any_qupath = any(d is not None for d in qupath_dirs)
    if model_name is None and config is None and model_path is None and not any_qupath:
        raise click.UsageError(
            "one of --model or (--config and --model-path) or --qupath-detection-dir"
            " or --qupath-geojson-detection-dir or --qupath-geojson-annotation-dir"
            " is required."
        )
    if (config is not None or model_path is not None) and model_name is not None:
        raise click.UsageError("--config and --model-path are mutually exclusive with --model.")
    if (config is not None) ^ (model_path is not None):
        raise click.UsageError("--config and --model-path must both be set if one is set.")
    if any_qupath and (model_name is not None or config is not None):
        raise click.UsageError(
            "--qupath-* directories are mutually exclusive with --model/--config/--model-path."
        )
    if sum(d is not None for d in qupath_dirs) > 1:
        # patch resolves detection-first while infer resolves annotation-first;
        # allowing a combo silently produces inconsistent patch/infer stages
        raise click.UsageError("pass at most ONE --qupath-* directory.")


def resolve_model(model_name, config, model_path) -> ModelHandle:
    if model_name is not None:
        return get_registered_model(name=model_name)
    with open(config) as f:
        cfg = ModelConfiguration.from_dict(json.load(f))
    return ModelHandle(name=Path(config).stem, config=cfg, weights_path=str(model_path))


def model_flags(handle: ModelHandle) -> dict:
    """Derive object/stain flags from the model config.

    Unlike the reference — whose registered-model branch leaves these unbound
    (SURVEY.md §2.11) — flags default from the config for ALL model sources.
    """
    cfg = handle.config
    od = cfg.object_detection
    object_detection = od.name if (cfg.object_based and od is not None) else None
    return dict(
        object_based=cfg.object_based,
        object_detection=object_detection,
        mixed_precision=cfg.mixed_precision,
        stain_normalization=cfg.stain_normalization,
        halo_size_px=cfg.halo_size_pixels if cfg.object_based else 0,
        stardist_normalization_pmin=od.normalization_pmin if od else 1.0,
        stardist_normalization_pmax=od.normalization_pmax if od else 99.8,
    )


def compute_overlap(model_cfg, patch_overlap_ratio, patch_size_um, patch_size_px, *, object_based=False, allow_multi=False):
    """Resolve overlap from the three mutually-exclusive step options
    (reference: cli/patch.py:824-851)."""
    nonzero = sum(0 if d == 0 else 1 for d in [patch_overlap_ratio, patch_size_um, patch_size_px])
    if nonzero > 1 and not allow_multi:
        raise click.ClickException(
            "Only one of --patch-overlap-ratio, --patch-size-um, --patch-size-px is allowed"
        )
    if nonzero == 1 and object_based and not allow_multi:
        raise click.ClickException("--object-based doesn't work with variational patch size")
    if patch_overlap_ratio != 0.0:
        return patch_overlap_ratio
    if patch_size_um != 0.0:
        full_um = model_cfg.patch_size_pixels * model_cfg.spacing_um_px
        if patch_size_um > full_um:
            raise click.ClickException("--patch-size-um has to be smaller than patch size")
        return 1.0 - patch_size_um / full_um
    if patch_size_px != 0:
        if patch_size_px > model_cfg.patch_size_pixels:
            raise click.ClickException("--patch-size-px must not be larger than patch size")
        return 1.0 - float(patch_size_px) / float(model_cfg.patch_size_pixels)
    return 0.0


def list_slides(wsi_dir: URIPath) -> list[URIPath]:
    return sorted([p for p in wsi_dir.iterdir() if p.is_file()])


def qupath_pseudo_model(
    wsi_paths, qupath_dir, *, geojson: bool, name_as_class: bool,
    patch_size_pixels: int, spacing_um_px: float, architecture: str,
) -> ModelHandle:
    """Synthesize a pseudo-model whose classes are the union of QuPath classes
    (reference: cli/patch.py:700-816)."""
    import pandas as pd

    class_names: list[str] = []
    for wsi_path in wsi_paths:
        if geojson:
            f = URIPath(qupath_dir) / wsi_path.with_suffix(".geojson").name
            if not f.exists():
                continue
            feats = json.loads(f.read_text()).get("features", [])
            for feat in feats:
                props = feat.get("properties") or {}
                if name_as_class:
                    val = props.get("name")
                else:
                    cls = props.get("classification")
                    val = cls.get("name") if isinstance(cls, dict) else cls
                if val:
                    class_names.append(str(val).strip().replace(" ", "_").lower())
        else:
            f = URIPath(qupath_dir) / wsi_path.with_suffix(".txt").name
            if not f.exists():
                continue
            with f.open("r", encoding="utf-8") as fp:
                df = pd.read_csv(fp, delimiter="\t")
            col = "Name" if name_as_class else "Classification"
            # dropna: unclassified detections read as NaN, which would make
            # sorted(set(...)) raise on str<float comparison
            class_names.extend(
                df[col]
                .dropna()
                .str.strip()
                .str.replace(" ", "_", regex=False)
                .str.lower()
                .unique()
                .tolist()
            )
    class_names = sorted(set(class_names))
    cfg = ModelConfiguration(
        architecture=architecture,
        num_classes=len(class_names),
        class_names=class_names,
        patch_size_pixels=patch_size_pixels,
        spacing_um_px=spacing_um_px,
        transform=[],
    )
    return ModelHandle(name=architecture, config=cfg)


def require_h5py() -> None:
    """The patch files between the stages are HDF5; say so plainly where h5py
    is missing, before a stage starts."""
    try:
        import h5py  # noqa: F401
    except ImportError as err:
        raise click.ClickException(
            "the patch and infer stages hand the patch grid over in HDF5 files"
            " (results/patches/<slide>.h5), which needs h5py; it is not installed"
        ) from err
