"""Torch-semantics building blocks of the classifier models.

Counterpart of wsinsight_tpu/models/layers.py. The modules subclass the
torch layers they stand for, so their state-dict keys (``weight``,
``running_mean``, ``num_batches_tracked``, ...) are torchvision's and a zoo
checkpoint loads with ``load_state_dict(strict=True)``. What differs from
the stock layers is only what the JAX package pins down:

* ``Conv2d`` takes per-side padding ``(begin, end)`` as well as torch's
  symmetric int (TF-SAME pads stride-2 convs as (0, 1)); per-side padding is
  an explicit ``F.pad``.
* ``EvalBN`` is eval-mode batch norm with its scale and shift in float32,
  whatever the activations' dtype (``EvalBN`` at layers.py:72-91).
* ``global_avg_pool`` averages in float32.

Linear layers and max pooling are torch's own (``nn.Linear``;
``F.max_pool2d`` pads with -inf, as ``max_pool_torch`` does). Tensors are
NCHW; the engine runs them as channels_last.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d with zero padding that may differ per side.

    ``padding`` is a pair of entries, one per spatial axis, each an int
    (symmetric) or a ``(begin, end)`` pair.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1, padding: Any = 0,
                 bias: bool = True, groups: int = 1):
        pads = padding if isinstance(padding, (tuple, list)) else (padding, padding)
        pads = [(p, p) if isinstance(p, int) else (int(p[0]), int(p[1])) for p in pads]
        symmetric = all(p0 == p1 for p0, p1 in pads)
        super().__init__(
            in_ch, out_ch, kernel_size, stride,
            padding=tuple(p0 for p0, _ in pads) if symmetric else 0,
            bias=bias, groups=groups,
        )
        # F.pad order: last dim first -> (w_begin, w_end, h_begin, h_end)
        self._side_pad = None if symmetric else (*pads[1], *pads[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._side_pad is not None:
            x = F.pad(x, self._side_pad)
        return super().forward(x)


class EvalBN(nn.BatchNorm2d):
    """nn.BatchNorm2d in eval mode: y = (x - mean) * rsqrt(var + eps) * w + b,
    computed in float32 and returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1, 1, 1)
        return (x.float() * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)) + flatten, summed in float32."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)


def compute_in(dtype: torch.dtype, x: torch.Tensor):
    """Context for a forward in ``dtype`` with float32 parameters: the flax
    models' ``dtype`` becomes autocast. float32 needs no context."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, dtype=dtype)
