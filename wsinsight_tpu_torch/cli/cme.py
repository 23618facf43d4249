"""`wsinsight cme` — standalone CME analytics over existing model outputs.

The reference ships this as a legacy command left unregistered
(reference: wsinsight/cli/cme.py, cli/cli.py:53-55); registered here.

Counterpart of wsinsight_tpu/cli/cme.py, with the same options.
"""

from __future__ import annotations

import click

from . import _options as opt


@click.command()
@opt.io_options
@click.option("--cme-cellular", is_flag=True, default=False, show_default=True)
@click.option("--cme-annotation", is_flag=True, default=False, show_default=True)
@click.option("--cme-soft-mode", is_flag=True, default=False, show_default=True)
@click.option("--cme-clustering-k", type=int, default=0, show_default=True,
              help="Number of clusters; 0 = automatic (Leiden sweep).")
@click.option("--cme-clustering-resolutions", type=str, default="0.25,0.5,1.0,2.0",
              show_default=True)
@click.option("--cme-max-edge-len-um", type=float, default=25.0, show_default=True)
@click.option("--cme-max-cell-radius-um", type=float, default=15.0, show_default=True)
@click.option("--cme-k-hops", type=int, default=2, show_default=True)
@click.option("--cme-epochs", type=int, default=300, show_default=True)
def cme(
    *,
    wsi_dir,
    slide_paths,
    results_dir,
    references_dir,
    cme_cellular,
    cme_annotation,
    cme_soft_mode,
    cme_clustering_k,
    cme_clustering_resolutions,
    cme_max_edge_len_um,
    cme_max_cell_radius_um,
    cme_k_hops,
    cme_epochs,
) -> None:
    """Run cellular-microenvironment clustering on existing model outputs."""
    del references_dir
    from ..insightlib import cme_generation

    slide_paths = list(slide_paths) if slide_paths else None
    if wsi_dir is not None and slide_paths is None:
        slide_paths = opt.list_slides(wsi_dir)

    cme_generation(
        wsi_dir=wsi_dir,
        wsi_paths=slide_paths,
        results_dir=results_dir,
        max_edge_len_um=cme_max_edge_len_um,
        max_cell_radius_um=cme_max_cell_radius_um,
        k_hops=cme_k_hops,
        epochs=cme_epochs,
        cme_cellular=cme_cellular or not cme_annotation,
        cme_annotation=cme_annotation,
        cme_clustering_k=cme_clustering_k,
        cme_clustering_resolutions=cme_clustering_resolutions,
        cme_soft_mode=cme_soft_mode,
    )
    click.secho("\nWSInsight-cme tasks are all finished.\n", fg="green")
