"""`wsinsight infer` — batched model inference + exports + analytics.

CLI surface mirrors the reference (reference: wsinsight/cli/infer.py:299-1310).
Fixes carried from SURVEY.md §2.11: flags default from the model config for
registered models, and analytics receive the actual slide list instead of a
variable bound only in QuPath branches.

Counterpart of wsinsight_tpu/cli/infer.py, with the same options. The port
runs patch classification into the model-output CSVs, with --fast-input and
stain-normalized models, and end2end cell models (CellViT: one row per
nucleus, the polygons into the patch files); the exporters, QuPath
pseudo-models, the analytics and StarDist models raise ``click.UsageError``
naming their ROADMAP.md item (``_options``). Reading the patch files needs
h5py.
"""

from __future__ import annotations

import os

import click

from ..engine import run_inference
from ..parallel.mesh import force_cpu_requested
from ..utils.metadata import print_system_info, write_run_metadata
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
              help="Number of CME clusters; 0 = automatic (Leiden sweep; Louvain fallback).")
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
    opt.refuse_unported(ctx.params)
    model_obj = opt.resolve_model(model_name, config, model_path)
    flags = opt.model_flags(model_obj)
    opt.refuse_unported_model(flags, model_obj.config.architecture)
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

    # Validates the step options as the JAX command does; only the exporters
    # (not ported) read the overlap.
    opt.compute_overlap(
        model_obj.config,
        patch_overlap_ratio,
        patch_size_um,
        patch_size_px,
        object_based=flags["object_based"],
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

    if failed_patching:
        click.secho(f"\nPatching failed for {len(failed_patching)} slides", fg="yellow")
        click.secho("\n".join(failed_patching), fg="yellow")
    if failed_inference:
        click.secho(f"\nInference failed for {len(failed_inference)} slides", fg="yellow")
        click.secho("\n".join(failed_inference), fg="yellow")

    out = write_run_metadata(results_dir, "infer", model_obj)
    click.echo(f"\nSaved metadata about run to {out}\n")
    click.secho("\nWSInsight-infer tasks are all finished.\n", fg="green")
