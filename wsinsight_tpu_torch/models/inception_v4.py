"""InceptionV4 (Cadene layout), with or without batch norm.

Counterpart of wsinsight_tpu/models/inception_v4.py. Serves
``breast-tumor-inception_v4.tcga-brca`` (batch norm, eps 1e-3) and
``pancancer-lymphocytes-inceptionv4.tcga`` (no batch norm: conv biases
instead, as in that model's TF-Slim conversion). Module names are the keys
of those state dicts (``features.N.branchK.M.conv`` / ``.bn``,
``branch1_1a``, ..., ``last_linear``), so a zoo checkpoint loads with
``load_state_dict(strict=True)``. Input is NCHW (channels_last from the
engine); the output is float32.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, EvalBN, compute_in, global_avg_pool


class BasicConv2d(nn.Module):
    """conv -> bn (eps 1e-3) -> relu; without batch norm, conv (with bias) -> relu."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1, padding=0,
                 batch_norm: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=not batch_norm)
        self.bn = EvalBN(out_ch, eps=1e-3) if batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return torch.relu(x if self.bn is None else self.bn(x))


class _Branches(nn.Module):
    """Concatenation of named branches along channels, in declaration order."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([branch(x) for branch in self.children()], dim=1)


class InceptionV4(nn.Module):
    """Cadene's pretrainedmodels InceptionV4 (eval mode)."""

    def __init__(self, num_classes: int = 2, batch_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

        def bc(in_ch, out_ch, k, s=1, p=0):
            return BasicConv2d(in_ch, out_ch, k, s, p, batch_norm)

        def branches(**named) -> _Branches:
            block = _Branches()
            for name, mod in named.items():
                block.add_module(name, mod)
            return block

        def avg_pool():  # padded by 1, averaging only the real pixels
            return nn.AvgPool2d(3, 1, 1, count_include_pad=False)

        seq = nn.Sequential
        features = [bc(3, 32, 3, 2), bc(32, 32, 3), bc(32, 64, 3, 1, 1)]
        features.append(branches(maxpool=nn.MaxPool2d(3, 2), conv=bc(64, 96, 3, 2)))  # Mixed_3a
        features.append(branches(  # Mixed_4a
            branch0=seq(bc(160, 64, 1), bc(64, 96, 3)),
            branch1=seq(bc(160, 64, 1), bc(64, 64, (1, 7), p=(0, 3)),
                        bc(64, 64, (7, 1), p=(3, 0)), bc(64, 96, 3)),
        ))
        features.append(branches(conv=bc(192, 192, 3, 2), maxpool=nn.MaxPool2d(3, 2)))  # Mixed_5a
        for _ in range(4):  # InceptionA
            features.append(branches(
                branch0=bc(384, 96, 1),
                branch1=seq(bc(384, 64, 1), bc(64, 96, 3, p=1)),
                branch2=seq(bc(384, 64, 1), bc(64, 96, 3, p=1), bc(96, 96, 3, p=1)),
                branch3=seq(avg_pool(), bc(384, 96, 1)),
            ))
        features.append(branches(  # ReductionA
            branch0=bc(384, 384, 3, 2),
            branch1=seq(bc(384, 192, 1), bc(192, 224, 3, p=1), bc(224, 256, 3, 2)),
            branch2=nn.MaxPool2d(3, 2),
        ))
        for _ in range(7):  # InceptionB
            features.append(branches(
                branch0=bc(1024, 384, 1),
                branch1=seq(bc(1024, 192, 1), bc(192, 224, (1, 7), p=(0, 3)),
                            bc(224, 256, (7, 1), p=(3, 0))),
                branch2=seq(bc(1024, 192, 1), bc(192, 192, (7, 1), p=(3, 0)),
                            bc(192, 224, (1, 7), p=(0, 3)), bc(224, 224, (7, 1), p=(3, 0)),
                            bc(224, 256, (1, 7), p=(0, 3))),
                branch3=seq(avg_pool(), bc(1024, 128, 1)),
            ))
        features.append(branches(  # ReductionB
            branch0=seq(bc(1024, 192, 1), bc(192, 192, 3, 2)),
            branch1=seq(bc(1024, 256, 1), bc(256, 256, (1, 7), p=(0, 3)),
                        bc(256, 320, (7, 1), p=(3, 0)), bc(320, 320, 3, 2)),
            branch2=nn.MaxPool2d(3, 2),
        ))
        for _ in range(3):  # InceptionC
            features.append(_InceptionC(bc))
        self.features = seq(*features)
        self.last_linear = nn.Linear(1536, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with compute_in(self.dtype, x):
            return self.last_linear(global_avg_pool(self.features(x))).float()


class _InceptionC(nn.Module):
    """InceptionC: its 1x3 / 3x1 pairs split one branch in two."""

    def __init__(self, bc):
        super().__init__()
        self.branch0 = bc(1536, 256, 1)
        self.branch1_0 = bc(1536, 384, 1)
        self.branch1_1a = bc(384, 256, (1, 3), p=(0, 1))
        self.branch1_1b = bc(384, 256, (3, 1), p=(1, 0))
        self.branch2_0 = bc(1536, 384, 1)
        self.branch2_1 = bc(384, 448, (3, 1), p=(1, 0))
        self.branch2_2 = bc(448, 512, (1, 3), p=(0, 1))
        self.branch2_3a = bc(512, 256, (1, 3), p=(0, 1))
        self.branch2_3b = bc(512, 256, (3, 1), p=(1, 0))
        self.branch3 = nn.Sequential(nn.AvgPool2d(3, 1, 1, count_include_pad=False),
                                     bc(1536, 256, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1_0(x)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        return torch.cat([self.branch0(x), self.branch1_1a(b1), self.branch1_1b(b1),
                          self.branch2_3a(b2), self.branch2_3b(b2), self.branch3(x)], dim=1)


def inception_v4(num_classes: int, dtype: torch.dtype = torch.float32) -> InceptionV4:
    return InceptionV4(num_classes=num_classes, batch_norm=True, dtype=dtype)


def inception_v4nobn(num_classes: int, dtype: torch.dtype = torch.float32) -> InceptionV4:
    return InceptionV4(num_classes=num_classes, batch_norm=False, dtype=dtype)
