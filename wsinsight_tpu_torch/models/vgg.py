"""VGG16 (torchvision layout) with a replaceable final classifier.

Counterpart of wsinsight_tpu/models/vgg.py. Serves
``breast-tumor-vgg16mod.tcga-brca``; ``vgg16mod`` is the same graph with
another checkpoint. The modules sit at torchvision's indices
(``features.{0,2,5,...,28}``, ``classifier.{0,3,6}``; ReLU, pooling and
dropout fill the others), so a zoo checkpoint loads with
``load_state_dict(strict=True)``. Input is NCHW (channels_last from the
engine); the output is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, compute_in

# torchvision vgg16 "D": output channels per conv, "M" for a 2x2 max pool.
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    """torchvision.models.vgg16 (eval mode)."""

    def __init__(self, num_classes: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers: list[nn.Module] = []
        in_ch = 3
        for item in _VGG16_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(in_ch, item, 3, 1, 1), nn.ReLU()]
                in_ch = item
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with compute_in(self.dtype, x):
            x = F.adaptive_avg_pool2d(self.features(x), (7, 7))
            # flatten of the NCHW-logical tensor is torch's (C, 7, 7) order,
            # whatever the memory format
            return self.classifier(torch.flatten(x, 1)).float()


def vgg16(num_classes: int, dtype: torch.dtype = torch.float32) -> VGG16:
    return VGG16(num_classes=num_classes, dtype=dtype)
