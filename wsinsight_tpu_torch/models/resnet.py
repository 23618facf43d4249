"""ResNet-34/50 and pre-activation ResNet-34, torchvision state-dict compatible.

Counterpart of wsinsight_tpu/models/resnet.py. Module names are the torch
keys (``conv1``, ``layer2.0.downsample.1``, ``bn_final``, ``fc``), so a zoo
checkpoint loads with ``load_state_dict(strict=True)``. Input is NCHW (run
as channels_last by the engine); the ``fc`` output is float32. Parameters
are float32; ``dtype`` is the compute dtype, bfloat16 running under autocast
as the flax models' ``dtype`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, EvalBN, compute_in, global_avg_pool


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(in_ch, width, 3, stride, 1, bias=False)
        self.bn1 = EvalBN(width)
        self.conv2 = Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = EvalBN(width)
        self.downsample = _downsample(in_ch, width, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = EvalBN(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = EvalBN(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = EvalBN(out_ch)
        self.downsample = _downsample(in_ch, out_ch, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + identity)


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential | None:
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, bias=False), EvalBN(out_ch))


class ResNet(nn.Module):
    """torchvision.models.resnet{34,50} (eval mode)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), bottleneck: bool = False,
                 num_classes: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        block = Bottleneck if bottleneck else BasicBlock
        expansion = 4 if bottleneck else 1
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = EvalBN(64)
        in_ch, width = 64, 64
        for li, blocks in enumerate(layers):
            seq = []
            for bi in range(blocks):
                seq.append(block(in_ch, width, 2 if li and not bi else 1))
                in_ch = width * expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))
            width *= 2
        self.n_layers = len(layers)
        self.fc = nn.Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with compute_in(self.dtype, x):
            x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
            for li in range(self.n_layers):
                x = getattr(self, f"layer{li + 1}")(x)
            return self.fc(global_avg_pool(x)).float()


class PreActBlock(nn.Module):
    """bn -> relu -> conv, the shortcut taken after the first pre-activation."""

    def __init__(self, in_ch: int, width: int, stride: int):
        super().__init__()
        self.bn1 = EvalBN(in_ch)
        self.conv1 = Conv2d(in_ch, width, 3, stride, 1, bias=False)
        self.bn2 = EvalBN(width)
        self.conv2 = Conv2d(width, width, 3, 1, 1, bias=False)
        self.downsample = None
        if stride != 1 or in_ch != width:
            self.downsample = nn.Sequential(Conv2d(in_ch, width, 1, stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = torch.relu(self.bn1(x))
        identity = x if self.downsample is None else self.downsample(pre)
        y = torch.relu(self.bn2(self.conv1(pre)))
        return self.conv2(y) + identity


class PreActResNet(nn.Module):
    """Pre-activation ResNet (He et al. 2016), ImageNet layout (the paad
    preactresnet34 zoo model): final bn -> relu before global pooling."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), num_classes: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        in_ch, width = 64, 64
        for li, blocks in enumerate(layers):
            seq = []
            for bi in range(blocks):
                seq.append(PreActBlock(in_ch, width, 2 if li and not bi else 1))
                in_ch = width
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))
            width *= 2
        self.n_layers = len(layers)
        self.bn_final = EvalBN(in_ch)
        self.fc = nn.Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with compute_in(self.dtype, x):
            x = F.max_pool2d(self.conv1(x), 3, 2, 1)
            for li in range(self.n_layers):
                x = getattr(self, f"layer{li + 1}")(x)
            x = torch.relu(self.bn_final(x))
            return self.fc(global_avg_pool(x)).float()


def resnet34(num_classes: int, dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), bottleneck=False, num_classes=num_classes, dtype=dtype)


def resnet50(num_classes: int, dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), bottleneck=True, num_classes=num_classes, dtype=dtype)


def preactresnet34(num_classes: int, dtype: torch.dtype = torch.float32) -> PreActResNet:
    return PreActResNet(layers=(3, 4, 6, 3), num_classes=num_classes, dtype=dtype)
