"""`wsinsight run` — one-shot patch + infer orchestration.

Mirrors the reference composition (reference: wsinsight/cli/run.py:620-689):
enumerate slides once, invoke the patch stage then the infer stage with each
stage's own parameter subset, optionally build a QuPath project.

Unlike the reference, which maintains hand-written lists of the parameter
names forwarded to each stage (reference: cli/run.py:89-155), this command
derives the forwarded subset from each subcommand's declared click params —
adding a flag to `patch` or `infer` automatically routes it through `run`.

Counterpart of wsinsight_tpu/cli/run.py. ``--qupath`` builds the QuPath project after both stages; it needs paquo and
a QuPath install, and raises without them as the JAX command does.
"""

from __future__ import annotations

import click

from ..utils.metadata import write_run_metadata
from . import _options as opt
from .infer import infer
from .patch import patch


def _adopt_params(*commands):
    """Merge the click params of `commands` onto the decorated function.

    Later duplicates (same param name) are dropped, so options shared by the
    patch and infer stages appear once on `run`. Appends to __click_params__,
    which @click.command collects when it builds the Command (this decorator
    therefore sits below @click.command in the stack).
    """

    def deco(target):
        merged = list(getattr(target, "__click_params__", []))
        seen = {p.name for p in merged}
        for cmd in commands:
            for param in cmd.params:
                if param.name not in seen:
                    merged.append(param)
                    seen.add(param.name)
        target.__click_params__ = merged
        return target

    return deco


def _invoke_stage(ctx: click.Context, cmd: click.Command, params: dict) -> None:
    """Invoke `cmd` with the subset of `params` it declares."""
    accepted = {p.name for p in cmd.params}
    ctx.invoke(cmd, **{k: v for k, v in params.items() if k in accepted})


@click.command()
@click.pass_context
@click.option(
    "--qupath",
    is_flag=True,
    default=False,
    show_default=True,
    help="Create a QuPath project from the results (requires paquo + QuPath).",
)
@_adopt_params(patch, infer)
def run(ctx: click.Context, *, qupath: bool, **params) -> None:
    """Run the patch stage then the infer stage in one shot."""
    wsi_dir = params.get("wsi_dir")
    if wsi_dir is not None and not params.get("slide_paths"):
        # One directory listing shared by both stages (and by --qupath below).
        params["slide_paths"] = tuple(opt.list_slides(wsi_dir))

    _invoke_stage(ctx, patch, params)
    _invoke_stage(ctx, infer, params)

    if qupath:
        from ..writers import make_qupath_project

        click.echo("Creating QuPath project with results")
        make_qupath_project(
            wsi_dir, params["results_dir"], slide_paths=params.get("slide_paths")
        )

    results_dir = params["results_dir"]
    model_name = params.get("model_name")
    config = params.get("config")
    if model_name is not None or config is not None:
        model_obj = opt.resolve_model(model_name, config, params.get("model_path"))
        out = write_run_metadata(results_dir, "run", model_obj)
        click.echo(f"\nSaved metadata about run to {out}\n")
    click.secho("\nWSInsight tasks are all finished.\n", fg="green")
