"""Model zoo of the port: architecture registry and constructors.

Counterpart of wsinsight_tpu/models/__init__.py, with the same aliases.
Ported: every zoo classifier (the ResNet family, VGG16 / vgg16mod and
InceptionV4 with and without batch norm), CellViT (SAM-B/L/H, ViT-256 and
Virchow), HoVer-Net fast, and the H-Optimus-0 foundation encoder
(``FoundationViT``, pooled embedding, no head).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..errors import UnknownArchitectureError
from .cellvit import cellvit_256, cellvit_sam_b, cellvit_sam_h, cellvit_sam_l, cellvit_virchow
from .hovernet import hovernet_fast
from .inception_v4 import inception_v4, inception_v4nobn
from .resnet import preactresnet34, resnet34, resnet50
from .vgg import vgg16
from .vit import HOPTIMUS_VIT_G, FoundationViT

_REGISTRY: dict[str, Callable] = {}


def _register(fn: Callable, *names: str) -> None:
    for n in names:
        _REGISTRY[n.lower().replace("-", "_")] = fn


_register(resnet34, "resnet34")
_register(resnet50, "resnet50")
_register(preactresnet34, "preactresnet34", "preact_resnet34")
_register(inception_v4, "inception_v4", "inceptionv4")
_register(
    inception_v4nobn, "inception_v4nobn", "inceptionv4nobn", "inception_v4_no_batchnorm",
    "inceptionv4_no_batchnorm",
)
_register(vgg16, "vgg16", "vgg16mod", "vgg16_mod")
_register(cellvit_sam_h, "cellvit_sam_h", "cellvit-sam-h")
_register(cellvit_sam_l, "cellvit_sam_l", "cellvit-sam-l")
_register(cellvit_sam_b, "cellvit_sam_b", "cellvit-sam-b")
_register(cellvit_256, "cellvit_256", "cellvit-256")
_register(cellvit_virchow, "cellvit_virchow", "cellvit-virchow")
_register(hovernet_fast, "hovernet_fast", "hovernet-fast", "hovernet_fast_pannuke")


def _hoptimus(num_classes: int = 0, dtype: torch.dtype = torch.float32):
    """H-Optimus-0 foundation encoder (pooled cls embedding; no head —
    num_classes is accepted for the registry's signature)."""
    del num_classes
    return FoundationViT(HOPTIMUS_VIT_G, dtype=dtype)


_register(_hoptimus, "hoptimus", "hoptimus0", "h_optimus_0")


def available_architectures() -> list[str]:
    return sorted(_REGISTRY)


def is_cell_architecture(architecture: str) -> bool:
    return architecture.lower().replace("-", "_").startswith(("cellvit", "hovernet"))


def create_model(architecture: str, num_classes: int, dtype: torch.dtype = torch.float32,
                 **kwargs):
    """Instantiate the torch module (eval mode) for a zoo architecture name.
    ``kwargs`` go to the constructor (``halo_size`` and ``img_size`` for
    the cell models)."""
    key = architecture.lower().replace("-", "_")
    if key not in _REGISTRY:
        raise UnknownArchitectureError(
            f"architecture '{architecture}' is not yet ported to torch;"
            f" ported: {available_architectures()}"
        )
    return _REGISTRY[key](num_classes=num_classes, dtype=dtype, **kwargs).eval()
