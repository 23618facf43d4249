"""Top-level click group (reference: wsinsight/cli/cli.py:22-55).

Counterpart of wsinsight_tpu/cli/cli.py: the ``patch``, ``infer``, ``run``,
``hplot``, ``cme`` and ``models`` commands. With a coordinator set
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) the
process joins the group before any command runs, and ``infer`` runs its
share of the slides (parallel/multihost.py).
"""

from __future__ import annotations

import logging
import os

import click

from .._version import __version__
from ..wsi import set_backend


@click.group()
@click.option(
    "--backend",
    default=None,
    help="Backend for reading whole slide images ('tpu' built-in reader,"
    " 'tiffslide' or 'openslide' if installed).",
    type=click.Choice(["tpu", "tiffslide", "openslide"]),
)
@click.option(
    "--log-level",
    default="info",
    type=click.Choice(["debug", "info", "warning", "error", "critical"]),
    help="Set the loudness of logging.",
)
@click.version_option(version=__version__)
def cli(backend: str | None = None, log_level: str = "info") -> None:
    """WSInsight (PyTorch/CUDA port): pathology inference on whole slide images."""
    levels = {
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warning": logging.WARNING,
        "error": logging.ERROR,
        "critical": logging.CRITICAL,
    }
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(module)s:%(lineno)d - %(message)s",
        level=levels[log_level],
    )
    # Multi-host: join the group before any command runs; the runner's own
    # call stays as an idempotent backstop for API users.
    if os.getenv("JAX_COORDINATOR_ADDRESS"):
        from ..parallel.multihost import MultiHostUsageError, maybe_initialize_distributed

        try:
            maybe_initialize_distributed()
        except MultiHostUsageError as err:
            raise click.UsageError(str(err)) from err
    if backend is not None:
        set_backend(backend)


from .cme import cme  # noqa: E402
from .hplot import hplot  # noqa: E402
from .infer import infer  # noqa: E402
from .patch import patch  # noqa: E402
from .run import run  # noqa: E402

cli.add_command(run)
cli.add_command(patch)
cli.add_command(infer)
cli.add_command(hplot)
cli.add_command(cme)

from .models_cmd import models_cmd  # noqa: E402

cli.add_command(models_cmd)
