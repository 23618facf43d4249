"""Device resolution and batch padding.

Counterpart of wsinsight_tpu/parallel/mesh.py. The port runs on the card:
an entry point given ``device=None`` takes ``cuda:0``. The CPU is used only
when the caller passes ``device="cpu"`` or sets ``WSINFER_FORCE_CPU``
(reference: run_inference.py:151-160). With neither, and no CUDA, the entry
point raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import os

import torch


def force_cpu_requested() -> bool:
    """True when WSINFER_FORCE_CPU asks for the CPU (same values as the JAX
    package's ``force_cpu_if_requested``)."""
    return os.getenv("WSINFER_FORCE_CPU", "0").lower() not in {"0", "f", "false"}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on, by the rule in the module docstring."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        return dev
    if force_cpu_requested():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or set"
            " WSINFER_FORCE_CPU=1 to run on the CPU"
        )
    return torch.device("cuda", 0)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
