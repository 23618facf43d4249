"""`wsinsight hplot` — standalone H-Plot analytics over existing model outputs.

The reference ships this as a legacy command left unregistered
(reference: wsinsight/cli/hplot.py, cli/cli.py:53-55); here it is registered
as a first-class command so analytics can run without re-invoking inference.

Counterpart of wsinsight_tpu/cli/hplot.py, with the same options.
"""

from __future__ import annotations

import click

from . import _options as opt


@click.command()
@opt.io_options
@click.option("--hplot-max-neighbor-distance", type=float, default=25.0, show_default=True)
@click.option("--hplot-base-types", type=str, multiple=True, required=True)
@click.option("--hplot-target-types", type=str, multiple=True, required=True)
@click.option("--hplot-k", type=int, default=2, show_default=True)
@click.option("--hplot-n", type=int, default=8, show_default=True)
@click.option("--hplot-r", type=float, default=0.5, show_default=True)
@click.option("--hplot-range-max", type=float, default=None)
@click.option("--hplot-range-min", type=float, default=None)
@click.option("--hplot-samples-with-valid-range-only", is_flag=True, default=False)
@click.option("-n", "--num-workers", type=click.IntRange(min=1), default=4, show_default=True)
def hplot(
    *,
    wsi_dir,
    slide_paths,
    results_dir,
    references_dir,
    hplot_max_neighbor_distance,
    hplot_base_types,
    hplot_target_types,
    hplot_k,
    hplot_n,
    hplot_r,
    hplot_range_max,
    hplot_range_min,
    hplot_samples_with_valid_range_only,
    num_workers,
) -> None:
    """Run H-Plot tumor-border analytics on existing model-output CSVs."""
    del references_dir
    from ..insightlib import hplot_generation

    slide_paths = list(slide_paths) if slide_paths else None
    if wsi_dir is not None and slide_paths is None:
        slide_paths = opt.list_slides(wsi_dir)

    failed = hplot_generation(
        wsi_dir=wsi_dir,
        wsi_paths=slide_paths,
        results_dir=results_dir,
        base_type_list=[c.strip().replace(" ", "_").lower() for c in hplot_base_types],
        target_type_list=[c.strip().replace(" ", "_").lower() for c in hplot_target_types],
        max_neighbor_distance_um=hplot_max_neighbor_distance,
        hplot_k=hplot_k,
        hplot_N=hplot_n,
        hplot_R=hplot_r,
        hplot_range_max=hplot_range_max,
        hplot_range_min=hplot_range_min,
        hplot_samples_with_valid_range_only=hplot_samples_with_valid_range_only,
        num_workers=num_workers,
    )
    if failed:
        click.secho(f"H-Plot generation failed for {len(failed)} slides", fg="yellow")
        click.secho("\n".join(failed), fg="yellow")
    click.secho("\nWSInsight-hplot tasks are all finished.\n", fg="green")
