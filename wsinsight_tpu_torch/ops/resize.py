"""Linear and cubic resize with the semantics of ``jax.image.resize``
(methods "linear"/"bilinear" and "cubic"/"bicubic").

The JAX package resizes with ``jax.image.resize``, which samples at
half-pixel centres and, when it downsamples, widens the kernel (the
triangle, or Keys' cubic with a = -0.5) by 1/scale (antialiasing). ``F.interpolate`` does neither in the same way, so the
port builds the same separable weight matrices in numpy, as
``jax.image.scale_and_translate`` does (in float32, normalised per output),
and applies them as products on the tensor's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, as jax evaluates it."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= f32(1.0), ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= f32(2.0), f32(0.0), out).astype(f32)


def _resize_weights(in_size: int, out_size: int, kernel) -> np.ndarray:
    """(out_size, in_size) float32 matrix of ``jax.image.resize``'s weights
    for one axis (``compute_weight_mat`` with antialiasing)."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(np.float32)


@functools.lru_cache(maxsize=64)
def linear_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 matrix of ``jax.image.resize``'s linear
    (triangle) kernel with antialiasing, for one axis."""
    return _resize_weights(in_size, out_size, _triangle)


@functools.lru_cache(maxsize=64)
def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 matrix of ``jax.image.resize``'s cubic
    (Keys, a = -0.5) kernel with antialiasing, for one axis."""
    return _resize_weights(in_size, out_size, _keys_cubic)


_WEIGHTS = {"linear": linear_resize_weights, "cubic": cubic_resize_weights}


@functools.lru_cache(maxsize=64)
def _device_weights(in_size: int, out_size: int, device: torch.device,
                    method: str = "linear") -> torch.Tensor:
    return torch.from_numpy(_WEIGHTS[method](in_size, out_size)).to(device)


def resize_axis(x: torch.Tensor, dim: int, out_size: int, method: str = "linear") -> torch.Tensor:
    """Resize float32 ``x`` along ``dim`` to ``out_size`` with ``method``
    ("linear" or "cubic"); unchanged sizes pass through, as in
    ``jax.image.resize``."""
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    w = _device_weights(in_size, out_size, x.device, method)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.tensordot(x.float(), w, dims=([dim], [1]))  # resized axis last
    return y.movedim(-1, dim)
