"""Multi-host execution: slides fan out round-robin over processes.

Counterpart of wsinsight_tpu/parallel/multihost.py. Within a host the
engines split each batch over the host's cards (parallel/mesh.py); across
hosts the unit of work is the slide: inference is embarrassingly parallel
over slides, and per-slide CSVs are exact because patch order is
deterministic from the grid, so the fan-out needs no collectives.

The environment contract is the JAX package's, so the same launch scripts
work: ``JAX_COORDINATOR_ADDRESS`` (host:port of process 0),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Unlike JAX on a Cloud TPU pod,
a GPU host detects neither the count nor the rank, so both must be set when
a coordinator is. ``maybe_initialize_distributed()`` joins the group
(``torch.distributed`` over gloo: a rendezvous, no tensors cross it), and
``shard_slides_for_host(...)`` keeps this process's slides. Every host runs
the same CLI command against a shared results directory; the per-slide
resume contract makes retries and stragglers idempotent.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence, TypeVar

import torch.distributed as dist

T = TypeVar("T")


class MultiHostUsageError(ValueError):
    """A coordinator is set without the process count or rank."""


# How long a process waits at the rendezvous for the others.
_JOIN_TIMEOUT = datetime.timedelta(seconds=300)


def maybe_initialize_distributed() -> bool:
    """Join the process group when a coordinator is configured (the
    variables in the module docstring). Repeat calls do nothing. Returns
    True when running multi-process."""
    addr = os.getenv("JAX_COORDINATOR_ADDRESS")
    if addr and not _joined():
        count, rank = os.getenv("JAX_NUM_PROCESSES"), os.getenv("JAX_PROCESS_ID")
        if not count or not rank:
            raise MultiHostUsageError(
                f"JAX_COORDINATOR_ADDRESS={addr} is set, so JAX_NUM_PROCESSES (the process"
                " count) and JAX_PROCESS_ID (this process's rank, 0-based) must be set too;"
                " a GPU host cannot detect them"
            )
        try:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{addr}", world_size=int(count), rank=int(rank),
                timeout=_JOIN_TIMEOUT,
            )
        except Exception as err:
            # Falling back would run the WHOLE cohort on every host and race
            # the shared results directory: that must be loud, not a pass.
            raise RuntimeError(
                "torch.distributed.init_process_group() failed with a coordinator"
                f" configured (JAX_COORDINATOR_ADDRESS set): {err}. Refusing"
                " to degrade to independent single-host runs against a"
                " shared results directory."
            ) from err
    return process_info()[1] > 1


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_info() -> tuple[int, int]:
    """(rank, process count): the group's, or (0, 1) outside one."""
    return (dist.get_rank(), dist.get_world_size()) if _joined() else (0, 1)


def shard_slides_for_host(items: Sequence[T]) -> list[T]:
    """Deterministic round-robin shard of the slide list for this host."""
    idx, count = process_info()
    if count <= 1:
        return list(items)
    return [item for i, item in enumerate(items) if i % count == idx]
