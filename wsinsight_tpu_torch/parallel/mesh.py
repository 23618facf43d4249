"""The devices an engine runs on, and batch padding.

Counterpart of wsinsight_tpu/parallel/mesh.py. The port runs on the card:
an entry point given ``device=None`` takes ``cuda:0``, and an engine given
neither ``device`` nor ``devices`` takes every visible card
(``resolve_devices``), as ``get_data_mesh`` takes every local device. The
CPU is used only when the caller passes ``device="cpu"`` (or a list of CPU
devices) or sets ``WSINFER_FORCE_CPU`` (reference: run_inference.py:151-160).
With neither, and no CUDA, the entry point raises instead of carrying on
quietly on the CPU.

An explicit ``devices`` list may name one device more than once: each entry
is a replica of its own, so ``["cpu", "cpu"]`` or ``["cuda:0", "cuda:0"]``
drives the split over replicas on a machine with one device.
"""

from __future__ import annotations

import contextlib
import os
from typing import Sequence

import torch


def force_cpu_requested() -> bool:
    """True when WSINFER_FORCE_CPU asks for the CPU (same values as the JAX
    package's ``force_cpu_if_requested``)."""
    return os.getenv("WSINFER_FORCE_CPU", "0").lower() not in {"0", "f", "false"}


def _checked(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", 0)
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but {torch.cuda.device_count()}"
                               " CUDA device(s) are visible")
    return dev


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on, by the rule in the module docstring."""
    if device is not None:
        return _checked(device)
    if force_cpu_requested():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or set"
            " WSINFER_FORCE_CPU=1 to run on the CPU"
        )
    return torch.device("cuda", 0)


def resolve_devices(
    devices: Sequence[str | torch.device] | None = None,
    device: str | torch.device | None = None,
    max_devices: int | None = None,
) -> list[torch.device]:
    """The devices an engine runs on, one replica each: ``devices`` as
    given; else ``[device]``; else every visible card (the CPU under
    WSINFER_FORCE_CPU). ``max_devices`` keeps the first that many."""
    if devices is not None and device is not None:
        raise ValueError("pass device or devices, not both")
    if devices is not None:
        out = [_checked(d) for d in devices]
        if not out:
            raise ValueError("devices is empty")
    elif device is not None or force_cpu_requested():
        out = [resolve_device(device)]
    else:
        resolve_device()  # raises without CUDA
        out = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return out[:max_devices] if max_devices else out


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` for a card, nothing for the CPU: the
    context a replica's work is enqueued under."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def device_batch_size(batch_size: int, devices: Sequence) -> int:
    """Round batch size up so it divides evenly across the devices."""
    return pad_to_multiple(batch_size, len(devices))
