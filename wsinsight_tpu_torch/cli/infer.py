"""`wsinsight infer` — batched model inference + exports + analytics.

CLI surface mirrors the reference (reference: wsinsight/cli/infer.py:299-1310).
Fixes carried from SURVEY.md §2.11: flags default from the model config for
registered models, and analytics receive the actual slide list instead of a
variable bound only in QuPath branches.

Counterpart of wsinsight_tpu/cli/infer.py, with the same options. The port
runs patch classification into the model-output CSVs, with --fast-input and
stain-normalized models, object-based classifiers on StarDist's nuclei,
end2end cell models (CellViT with SAM, ViT-256 or Virchow encoders,
HoVer-Net: one row per nucleus, the polygons into the patch files) and the
QuPath pseudo-models, writes the GeoJSON (--geojson) and OME-CSV (--omecsv)
exports of those CSVs, and runs the analytics on them: H-Plot (--hplot) and
CME (--cme-cellular, --cme-annotation) with their exports. Reading the patch
files needs h5py.
"""

from __future__ import annotations

import os

import click

from ..engine import run_inference
from ..parallel.mesh import force_cpu_requested
from ..uri_path import URIPath
from ..utils.metadata import print_system_info, write_run_metadata
from ..writers import write_geojsons, write_omecsvs
from . import _options as opt


def _num_cpus() -> int:
    return os.cpu_count() or 1


def default_infer_workers() -> int:
    """min(cpu, 2*accelerators) (reference: cli/infer.py:63-90): the CUDA
    cards, or one device where there are none or WSINFER_FORCE_CPU asks for
    the CPU. Runs inside a command body, never at import/decorator time."""
    import torch

    n_acc = 1 if force_cpu_requested() else max(1, torch.cuda.device_count())
    return max(1, min(_num_cpus(), 2 * n_acc))


def default_export_workers() -> int:
    c = _num_cpus()
    return max(1, min(c - c // 4, 16))


def default_stitch_workers() -> int:
    return max(1, min(8, _num_cpus() // 2))


@click.command()
@click.pass_context
@opt.io_options
@opt.qupath_options
@opt.model_options
@click.option("-b", "--batch-size", type=click.IntRange(min=1), default=32, show_default=True)
@click.option(
    # Default resolved lazily inside the command, after WSINFER_FORCE_CPU
    # is known.
    "-n", "--num-workers", type=click.IntRange(min=0), default=None,
    show_default="min(cpu, 2*accelerators)",
    help="Number of patch-decode worker threads.",
)
@click.option(
    "--export-workers", type=click.IntRange(min=0), default=default_export_workers(),
    show_default=True, help="Workers for GeoJSON/OME-CSV export pools.",
)
@click.option(
    "--stitch-workers", type=click.IntRange(min=0), default=default_stitch_workers(),
    show_default=True, help="Workers for cell-instance stitching.",
)
@click.option(
    "--speedup/--no-speedup", default=False, show_default=True,
    help="Run the forward pass in bfloat16 (the reference's disabled --speedup,"
    " functional here; relaxes the 1e-3 logit-parity guarantee).",
)
@click.option(
    "--fast-input/--no-fast-input", default=False, show_default=True,
    help="Thin-link input mode: ship patches as YUV 4:2:0 planes"
    " (reconstructed on device) and, for classifier models on JPEG slides,"
    " decode tiles at DCT half resolution. Halves-to-quarters the"
    " host->device bytes; lossy (chroma + DCT downsample), so exact RGB"
    " stays the default. Equivalent to WSINSIGHT_WIRE=yuv420 +"
    " WSINSIGHT_DECODE_SCALE=2 (+WSINSIGHT_HOST_RESIZE=1).",
)
@click.option("--geojson", is_flag=True, default=False, show_default=True,
              help="Write GeoJSON outputs.")
@click.option("--omecsv", is_flag=True, default=False, show_default=True,
              help="Write OME-CSV outputs.")
@opt.patch_geometry_options
@click.option("--hplot", is_flag=True, default=False, show_default=True,
              help="Run H-Plot tumor-border analytics.")
@click.option("--hplot-max-neighbor-distance", type=float, default=25.0, show_default=True)
@click.option("--hplot-base-types", type=str, multiple=True, default=())
@click.option("--hplot-target-types", type=str, multiple=True, default=())
@click.option("--hplot-k", type=int, default=2, show_default=True)
@click.option("--hplot-n", type=int, default=8, show_default=True)
@click.option("--hplot-r", type=float, default=0.5, show_default=True)
@click.option("--hplot-range-max", type=float, default=None)
@click.option("--hplot-range-min", type=float, default=None)
@click.option("--hplot-samples-with-valid-range-only", is_flag=True, default=False)
@click.option("--cme-cellular", is_flag=True, default=False, show_default=True,
              help="Run cellular-microenvironment clustering (per-cell outputs).")
@click.option("--cme-annotation", is_flag=True, default=False, show_default=True,
              help="Run CME region merging (annotation-level outputs).")
@click.option("--cme-soft-mode", is_flag=True, default=False, show_default=True)
@click.option("--cme-clustering-k", type=int, default=0, show_default=True,
              help="Number of CME clusters; 0 = automatic (Leiden sweep).")
@click.option("--cme-clustering-resolutions", type=str, default="0.25,0.5,1.0,2.0",
              show_default=True)
def infer(
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
    batch_size,
    num_workers,
    export_workers,
    stitch_workers,
    speedup,
    fast_input,
    geojson,
    omecsv,
    patch_overlap_ratio,
    patch_size_um,
    patch_size_px,
    hplot,
    hplot_max_neighbor_distance,
    hplot_base_types,
    hplot_target_types,
    hplot_k,
    hplot_n,
    hplot_r,
    hplot_range_max,
    hplot_range_min,
    hplot_samples_with_valid_range_only,
    cme_cellular,
    cme_annotation,
    cme_soft_mode,
    cme_clustering_k,
    cme_clustering_resolutions,
) -> None:
    """Run model inference on a directory of whole slide images."""
    qupath_dirs = (
        qupath_detection_dir,
        qupath_geojson_detection_dir,
        qupath_geojson_annotation_dir,
    )
    opt.validate_model_args(model_name, config, model_path, qupath_dirs)
    pseudo = model_name is None and config is None
    if not pseudo:
        model_obj = opt.resolve_model(model_name, config, model_path)
        flags = opt.model_flags(model_obj)
    opt.require_h5py()

    if num_workers is None:
        num_workers = default_infer_workers()
        ctx.params["num_workers"] = num_workers

    print_system_info()
    print("\nCommand line arguments")
    print("----------------------")
    for key, value in ctx.params.items():
        print(f"{key} = {value}")
    print("----------------------\n")

    if wsi_dir is not None and slide_paths is not None and len(slide_paths) == 0:
        slide_paths = None
    slide_paths = list(slide_paths) if slide_paths else None
    if wsi_dir is not None and slide_paths is None:
        slide_paths = opt.list_slides(wsi_dir)
        if not slide_paths:
            raise FileNotFoundError(f"no files exist in the slide directory: {wsi_dir}")

    if pseudo:
        use_annotation = qupath_geojson_annotation_dir is not None
        use_geojson = qupath_geojson_detection_dir is not None or use_annotation
        qdir = (
            qupath_geojson_annotation_dir
            if use_annotation
            else (qupath_geojson_detection_dir if use_geojson else qupath_detection_dir)
        )
        if wsi_dir is None and slide_paths is None:
            # Fall back to the patch stage's wsi_list.csv (the convention the
            # reference reads but never writes, SURVEY.md §2.11).
            wsi_list = results_dir / "wsi_list.csv"
            if wsi_list.exists():
                import pandas as pd

                listing = pd.read_csv(wsi_list.materialize())
                slide_paths = [URIPath(p) for p in listing["wsi_path"].tolist()]
            else:
                raise click.UsageError(
                    "--wsi-dir (or a prior patch stage's wsi_list.csv) is"
                    " required for QuPath pseudo-models."
                )
        model_obj = opt.qupath_pseudo_model(
            slide_paths or opt.list_slides(wsi_dir),
            qdir,
            geojson=use_geojson,
            name_as_class=qupath_name_as_class,
            patch_size_pixels=(
                qupath_annotation_patch_size if use_annotation else qupath_detection_patch_size
            ),
            spacing_um_px=qupath_spacing_um_px,
            architecture="qupath.geojson" if use_geojson else "qupath.detection",
        )
        flags = dict(
            object_based=not use_annotation,
            object_detection=None,
            mixed_precision=False,
            stain_normalization=False,
            halo_size_px=0,
            stardist_normalization_pmin=1.0,
            stardist_normalization_pmax=99.8,
        )

    overlap = opt.compute_overlap(
        model_obj.config,
        patch_overlap_ratio,
        patch_size_um,
        patch_size_px,
        object_based=flags["object_based"],
        allow_multi=qupath_detection_dir is not None or qupath_geojson_detection_dir is not None,
    )

    if not (results_dir / "patches").exists():
        raise click.ClickException(
            "No patches were created. Please see the logs above and check for"
            " errors. It is possible that no tissue was detected in the slides."
        )

    click.secho("\nRunning model inference.\n", fg="green")
    # --fast-input maps onto the engine's environment options (read per
    # slide, so setting them here covers ctx.invoke from `run` too), restored
    # afterwards so one invocation cannot leak into the next.
    fast_saved: dict[str, str | None] = {}
    if fast_input:
        for k, v in (
            ("WSINSIGHT_WIRE", "yuv420"),
            ("WSINSIGHT_DECODE_SCALE", "2"),
            ("WSINSIGHT_HOST_RESIZE", "1"),
        ):
            fast_saved[k] = os.environ.get(k)
            os.environ[k] = v
    try:
        failed_patching, failed_inference = run_inference(
            wsi_dir=wsi_dir,
            slide_paths=slide_paths,
            results_dir=results_dir,
            references_dir=references_dir,
            qupath_detection_dir=qupath_detection_dir,
            qupath_geojson_detection_dir=qupath_geojson_detection_dir,
            qupath_geojson_annotation_dir=qupath_geojson_annotation_dir,
            qupath_name_as_class=qupath_name_as_class,
            model_info=model_obj,
            halo_size_px=flags["halo_size_px"],
            batch_size=batch_size,
            num_workers=num_workers,
            stain_normalization=flags["stain_normalization"],
            object_based=flags["object_based"],
            object_detection=flags["object_detection"],
            mixed_precision=flags["mixed_precision"] or speedup,
            stitch_workers=stitch_workers,
        )
    finally:
        for k, old in fast_saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old

    csv_exports = None
    if geojson or omecsv:
        csv_exports = sorted(
            p
            for p in (results_dir / "model-outputs-csv").iterdir(files_only=True)
            if p.suffix == ".csv"
        )

    if geojson:
        click.echo("\nWriting inference results to GeoJSON files\n")
        write_geojsons(
            csvs=csv_exports or [],
            overlap=overlap,
            results_dir=results_dir,
            output_dir="model-outputs-geojson",
            prefix="prob",
            num_workers=export_workers,
            object_type="detection" if flags["object_based"] else "tile",
            set_classification=bool(flags["object_based"]),
        )

    if omecsv:
        click.echo("\nWriting inference results to OMECSV files\n")
        h5s = [
            p
            for p in (results_dir / "patches").iterdir(files_only=True)
            if p.suffix == ".h5"
        ]
        write_omecsvs(
            csvs=csv_exports or [],
            h5s=h5s,
            overlap=overlap,
            results_dir=results_dir,
            output_dir=URIPath("model-outputs-omecsv") if results_dir.scheme else "model-outputs-omecsv",
            prefix="prob",
            num_workers=export_workers,
        )

    if failed_patching:
        click.secho(f"\nPatching failed for {len(failed_patching)} slides", fg="yellow")
        click.secho("\n".join(failed_patching), fg="yellow")
    if failed_inference:
        click.secho(f"\nInference failed for {len(failed_inference)} slides", fg="yellow")
        click.secho("\n".join(failed_inference), fg="yellow")

    # --- H-Plot analytics ----------------------------------------------------
    if hplot and (len(hplot_base_types) != 0 and len(hplot_target_types) != 0):
        from ..insightlib import hplot_generation

        target_type_list = [c.strip().replace(" ", "_").lower() for c in hplot_target_types]
        base_type_list = [c.strip().replace(" ", "_").lower() for c in hplot_base_types]
        norm_classes = [str(c).strip().replace(" ", "_").lower() for c in model_obj.config.class_names]
        for tp in base_type_list + target_type_list:
            if tp not in norm_classes:
                raise click.ClickException(
                    "--hplot-target-types and --hplot-base-types must be classes of"
                    " the chosen model."
                )
        click.secho("\nRunning H-Plot generation.\n", fg="green")
        failed_hplot = hplot_generation(
            wsi_dir=wsi_dir,
            wsi_paths=slide_paths,
            results_dir=results_dir,
            base_type_list=base_type_list,
            target_type_list=target_type_list,
            max_neighbor_distance_um=hplot_max_neighbor_distance,
            hplot_k=hplot_k,
            hplot_N=hplot_n,
            hplot_R=hplot_r,
            hplot_range_max=hplot_range_max,
            hplot_range_min=hplot_range_min,
            hplot_samples_with_valid_range_only=hplot_samples_with_valid_range_only,
            num_workers=1 if num_workers == 0 else num_workers,
        )
        if failed_hplot:
            click.secho(f"\nH-Plot generation failed for {len(failed_hplot)} slides", fg="yellow")
            click.secho("\n".join(failed_hplot), fg="yellow")

        if geojson:
            click.echo("\nWriting H-Plot cellular results to GeoJSON files\n")
            hplot_cell_csvs = sorted(
                p
                for p in (results_dir / "hplot-outputs-csv" / "cells").iterdir(files_only=True)
                if p.suffix == ".csv"
            )
            write_geojsons(
                csvs=hplot_cell_csvs,
                overlap=overlap,
                results_dir=results_dir,
                output_dir="hplot-outputs-geojson",
                prefix="hplot",
                num_workers=export_workers,
                object_type="detection",
                set_classification=True,
                annotation_shape="box",
            )
        if omecsv:
            click.echo("\nWriting H-Plot cellular results to OMECSV files\n")
            hplot_cell_csvs = sorted(
                p
                for p in (results_dir / "hplot-outputs-csv" / "cells").iterdir(files_only=True)
                if p.suffix == ".csv"
            )
            write_omecsvs(
                csvs=hplot_cell_csvs,
                h5s=[],
                overlap=overlap,
                results_dir=results_dir,
                output_dir="hplot-outputs-omecsv",
                prefix="hplot",
                num_workers=export_workers,
            )
    elif hplot:
        raise click.ClickException(
            "H-Plot requires both --hplot-base-types and --hplot-target-types."
        )

    # --- CME analytics ---------------------------------------------------------
    if cme_cellular or cme_annotation:
        from ..insightlib import cme_generation

        click.secho("\nRunning cme generation.\n", fg="green")
        cme_generation(
            wsi_dir=wsi_dir,
            wsi_paths=slide_paths,
            results_dir=results_dir,
            max_edge_len_um=25,
            max_cell_radius_um=15,
            k_hops=2,
            alpha=1.0,
            use_hoptimus=False,
            hidden=64,
            out_dim=32,
            epochs=300,
            cme_cellular=cme_cellular,
            cme_annotation=cme_annotation,
            cme_clustering_k=cme_clustering_k,
            cme_clustering_resolutions=cme_clustering_resolutions,
            cme_soft_mode=cme_soft_mode,
        )
        if geojson and cme_cellular:
            click.echo("\nWriting CME detection cellular results to GeoJSON files\n")
            cme_cell_csvs = sorted(
                p
                for p in (results_dir / "cme-outputs-csv" / "cells").iterdir(files_only=True)
                if p.suffix == ".csv"
            )
            write_geojsons(
                csvs=cme_cell_csvs,
                overlap=overlap,
                results_dir=results_dir,
                output_dir="cme-outputs-geojson/cells",
                prefix="cme",
                num_workers=1 if export_workers == 0 else export_workers,
                object_type="detection",
                set_classification=True,
                annotation_shape="box",
            )

    out = write_run_metadata(results_dir, "infer", model_obj)
    click.echo(f"\nSaved metadata about run to {out}\n")
    click.secho("\nWSInsight-infer tasks are all finished.\n", fg="green")
