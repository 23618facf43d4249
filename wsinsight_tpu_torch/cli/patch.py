"""`wsinsight patch` — tissue segmentation + patch-grid planning.

CLI surface mirrors the reference (reference: wsinsight/cli/patch.py:236-900),
with the registered-model branch defect fixed (flags default from the model
config instead of being left unbound, SURVEY.md §2.11).

Counterpart of wsinsight_tpu/cli/patch.py, with the same options. The port
plans the tissue grid of classifier models, the halo grid of end2end cell
models (CellViT, HoVer-Net), StarDist's nuclei for object-based models and
the QuPath pseudo-models' boxes (TSV or GeoJSON detections, or the tissue
grid for GeoJSON annotations). Writing the patch files needs h5py.
"""

from __future__ import annotations

import click

from ..patchlib import segment_and_patch_directory_of_slides
from ..utils.metadata import print_system_info, write_run_metadata
from ..utils.profiling import stage_timer
from ..wsi import _validate_wsi_directory
from . import _options as opt


@click.command()
@click.pass_context
@opt.io_options
@opt.qupath_options
@opt.model_options
@click.option(
    "--cache-image-patches",
    is_flag=True,
    default=False,
    show_default=True,
    help="Cache decoded image patches into the HDF5 (/images dataset).",
)
@click.option(
    "--histoqc-dir",
    type=opt._uri_type(),
    default=None,
    help="Directory of HistoQC outputs; mask_use.png replaces segmentation.",
)
@click.option(
    "--seg-thumbsize",
    default=(2048, 2048),
    type=(int, int),
    show_default=True,
    help="Size of the thumbnail used for tissue segmentation.",
)
@click.option("--seg-median-filter-size", default=7, type=int, show_default=True)
@click.option("--seg-binary-threshold", default=7, type=int, show_default=True)
@click.option("--seg-closing-kernel-size", default=6, type=int, show_default=True)
@click.option("--seg-min-object-size-um2", default=200**2, type=float, show_default=True)
@click.option("--seg-min-hole-size-um2", default=190**2, type=float, show_default=True)
@opt.patch_geometry_options
def patch(
    ctx: click.Context,
    *,
    wsi_dir,
    slide_paths,
    results_dir,
    references_dir,
    qupath_detection_dir,
    qupath_geojson_detection_dir,
    qupath_geojson_annotation_dir,
    qupath_detection_patch_size,
    qupath_annotation_patch_size,
    qupath_spacing_um_px,
    qupath_name_as_class,
    model_name,
    config,
    model_path,
    cache_image_patches,
    histoqc_dir,
    seg_thumbsize,
    seg_median_filter_size,
    seg_binary_threshold,
    seg_closing_kernel_size,
    seg_min_object_size_um2,
    seg_min_hole_size_um2,
    patch_overlap_ratio,
    patch_size_um,
    patch_size_px,
) -> None:
    """Segment tissue and generate patch coordinates for a WSI directory."""
    qupath_dirs = (
        qupath_detection_dir,
        qupath_geojson_detection_dir,
        qupath_geojson_annotation_dir,
    )
    opt.validate_model_args(model_name, config, model_path, qupath_dirs)

    if wsi_dir is None:
        raise click.UsageError("--wsi-dir is required.")
    if not wsi_dir.exists():
        raise FileNotFoundError(f"Whole slide image directory not found: {wsi_dir}")

    slide_paths = list(slide_paths) if slide_paths else opt.list_slides(wsi_dir)
    if not slide_paths:
        raise FileNotFoundError(f"no files exist in the slide directory: {wsi_dir}")

    pseudo = model_name is None and config is None
    if not pseudo:
        model_obj = opt.resolve_model(model_name, config, model_path)
        flags = opt.model_flags(model_obj)
    opt.require_h5py()

    print_system_info()
    print("\nCommand line arguments")
    print("----------------------")
    for key, value in ctx.params.items():
        print(f"{key} = {value}")
    print("----------------------\n")

    if pseudo and (qupath_detection_dir is not None or qupath_geojson_detection_dir is not None):
        _validate_wsi_directory(wsi_dir)
        use_geojson = qupath_geojson_detection_dir is not None
        model_obj = opt.qupath_pseudo_model(
            slide_paths,
            qupath_geojson_detection_dir if use_geojson else qupath_detection_dir,
            geojson=use_geojson,
            name_as_class=qupath_name_as_class,
            patch_size_pixels=qupath_detection_patch_size,
            spacing_um_px=qupath_spacing_um_px,
            architecture="qupath.geojson" if use_geojson else "qupath.detection",
        )
        flags = dict(
            object_based=True, object_detection=None, mixed_precision=False,
            stain_normalization=False, halo_size_px=0,
            stardist_normalization_pmin=1.0, stardist_normalization_pmax=99.8,
        )
    elif pseudo:  # annotation dir
        _validate_wsi_directory(wsi_dir)
        model_obj = opt.qupath_pseudo_model(
            slide_paths,
            qupath_geojson_annotation_dir,
            geojson=True,
            name_as_class=qupath_name_as_class,
            patch_size_pixels=qupath_annotation_patch_size,
            spacing_um_px=qupath_spacing_um_px,
            architecture="qupath.geojson",
        )
        flags = dict(
            object_based=False, object_detection=None, mixed_precision=False,
            stain_normalization=False, halo_size_px=0,
            stardist_normalization_pmin=1.0, stardist_normalization_pmax=99.8,
        )

    if references_dir is not None and not flags["object_based"]:
        raise click.ClickException("--references-dir only works with object based model.")

    overlap = opt.compute_overlap(
        model_obj.config,
        patch_overlap_ratio,
        patch_size_um,
        patch_size_px,
        object_based=flags["object_based"],
        allow_multi=qupath_detection_dir is not None or qupath_geojson_detection_dir is not None,
    )

    click.secho("\nFinding patch coordinates...\n", fg="green")
    with stage_timer("patching"):
        segment_and_patch_directory_of_slides(
            wsi_dir=wsi_dir,
            slide_paths=slide_paths,
            save_dir=results_dir,
            qupath_detection_dir=qupath_detection_dir,
            qupath_geojson_detection_dir=qupath_geojson_detection_dir,
            qupath_geojson_annotation_dir=qupath_geojson_annotation_dir,
            patch_size_px=model_obj.config.patch_size_pixels,
            patch_spacing_um_px=model_obj.config.spacing_um_px,
            halo_size_px=flags["halo_size_px"],
            histoqc_dir=histoqc_dir,
            thumbsize=tuple(seg_thumbsize),
            median_filter_size=seg_median_filter_size,
            binary_threshold=seg_binary_threshold,
            closing_kernel_size=seg_closing_kernel_size,
            min_object_size_um2=seg_min_object_size_um2,
            min_hole_size_um2=seg_min_hole_size_um2,
            overlap=overlap,
            object_based=flags["object_based"],
            object_detection=flags["object_detection"],
            stardist_normalization_pmin=flags["stardist_normalization_pmin"],
            stardist_normalization_pmax=flags["stardist_normalization_pmax"],
            cache_image_patches=cache_image_patches,
        )

    if not (results_dir / "patches").exists():
        raise click.ClickException(
            "No patches were created. Please see the logs above and check for"
            " errors. It is possible that no tissue was detected in the slides."
            " If that is the case, please try different --seg-* parameters; for"
            " example, a lower binary threshold may be set."
        )

    out = write_run_metadata(results_dir, "patch", model_obj)
    click.echo(f"\nSaved metadata about run to {out}\n")
    click.secho("\nWSInsight-patch tasks are all finished.\n", fg="green")
