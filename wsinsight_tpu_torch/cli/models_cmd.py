"""`wsinsight models` — registry listing + checkpoint ingestion tooling.

Counterpart of wsinsight_tpu/cli/models_cmd.py, with its output, options
and exit codes:

* ``wsinsight models`` / ``wsinsight models ls`` — registry table
* ``wsinsight models convert IN [OUT] --architecture A --num-classes N
  [--input-size S] [--halo-size H] [--report]`` — torch checkpoint -> flax
  msgpack, with a per-layer mapping-coverage report.

No flax is needed: the flax params tree the checkpoint is mapped onto comes
from the port's own module (``models.convert.flax_template``), and the file
is written in flax's msgpack format (``save_flax_msgpack``), byte for byte
what the JAX command writes.
"""

from __future__ import annotations

from pathlib import Path

import click

from ..zoo import load_registry


@click.group(name="models", invoke_without_command=True)
@click.pass_context
def models_cmd(ctx: click.Context) -> None:
    """Model registry + conversion tools (run bare to list models)."""
    if ctx.invoked_subcommand is None:
        _print_registry()


def _print_registry() -> None:
    reg = load_registry()
    rows = []
    for name, entry in sorted(reg.models.items()):
        cfg = entry.get("config", {})
        rows.append(
            (
                name,
                cfg.get("architecture", "?"),
                f"{cfg.get('patch_size_pixels', '?')}px @ {cfg.get('spacing_um_px', '?')}um",
                ",".join(map(str, cfg.get("class_names", []))),
            )
        )
    if not rows:
        click.echo("No models registered.")
        return
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    w2 = max(len(r[2]) for r in rows)
    for name, arch, geom, classes in rows:
        click.echo(f"{name:<{w0}}  {arch:<{w1}}  {geom:<{w2}}  {classes}")


@models_cmd.command(name="ls")
def models_ls() -> None:
    """List registered models and their geometry."""
    _print_registry()


@models_cmd.command(name="convert")
@click.argument("input", type=click.Path(exists=True, dir_okay=False, path_type=Path))
@click.argument("output", required=False, type=click.Path(dir_okay=False, path_type=Path))
@click.option("--architecture", required=True, help="flax registry name (see `wsinsight models`)")
@click.option("--num-classes", type=int, required=True)
@click.option("--input-size", type=int, default=None,
              help="model input side in px (default 256 for cell models, 224 otherwise)")
@click.option("--halo-size", type=int, default=None, help="halo for cell models")
@click.option("--report", "show_report", is_flag=True,
              help="print per-layer mapping coverage; with no OUTPUT, report only")
def models_convert(
    input: Path,
    output: Path | None,
    architecture: str,
    num_classes: int,
    input_size: int | None,
    halo_size: int | None,
    show_report: bool,
) -> None:
    """Convert a torch checkpoint (state dict or TorchScript) to flax msgpack.

    With --report, prints how every torch tensor mapped onto the flax
    template (the ingestion report for real zoo weights: run it on a fresh
    download before trusting the conversion).
    """
    from ..models.convert import (
        conversion_report,
        convert_with_template,
        flax_template,
        load_torch_weights,
        normalize_hovernet_keys,
        save_flax_msgpack,
    )

    template = flax_template(architecture, num_classes, input_size, halo_size)
    sd = load_torch_weights(input)
    if architecture.lower().replace("-", "_").startswith("hovernet"):
        sd = normalize_hovernet_keys(sd)

    if show_report:
        rep = conversion_report(sd, template)
        click.echo(
            f"template leaves filled: {rep['template_filled']}/{rep['template_leaves']}"
            f"  (torch tensors: {rep['torch_tensors']})"
        )
        for problem in rep["problems"]:
            click.echo(f"  ! {problem}")
        if rep["ok"]:
            click.echo("mapping complete: every template leaf filled, no leftovers")
        if output is None:
            if not rep["ok"]:
                raise SystemExit(1)
            return
        params = rep["params"]
        if not rep["ok"]:
            raise click.ClickException(
                "conversion has mismatches (see report above); not writing output"
            )
    else:
        params = convert_with_template(sd, template, strict=True)

    assert output is not None
    sha = save_flax_msgpack(params, output)
    click.echo(f"wrote {output} (sha256={sha})")
