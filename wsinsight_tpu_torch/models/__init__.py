"""Model zoo of the port: architecture registry and constructors.

Counterpart of wsinsight_tpu/models/__init__.py, with the same aliases. This
slice ports the ResNet family; every other architecture raises
``UnknownArchitectureError``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..errors import UnknownArchitectureError
from .resnet import preactresnet34, resnet34, resnet50

_REGISTRY: dict[str, Callable] = {}


def _register(fn: Callable, *names: str) -> None:
    for n in names:
        _REGISTRY[n.lower().replace("-", "_")] = fn


_register(resnet34, "resnet34")
_register(resnet50, "resnet50")
_register(preactresnet34, "preactresnet34", "preact_resnet34")


def available_architectures() -> list[str]:
    return sorted(_REGISTRY)


def create_model(architecture: str, num_classes: int, dtype: torch.dtype = torch.float32):
    """Instantiate the torch module (eval mode) for a zoo architecture name."""
    key = architecture.lower().replace("-", "_")
    if key not in _REGISTRY:
        raise UnknownArchitectureError(
            f"architecture '{architecture}' is not yet ported to torch;"
            f" ported: {available_architectures()}"
        )
    return _REGISTRY[key](num_classes=num_classes, dtype=dtype).eval()
