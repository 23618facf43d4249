"""Patch preprocessing in torch: PIL-matched resize + ToTensor/Normalize/Scale.

Counterpart of wsinsight_tpu/ops/preprocess.py, with the same NHWC layout at
the public functions: (B, H, W, 3) uint8 in, (B, oh, ow, 3) float out.

* **Resize** reproduces PIL/torchvision ``Resize`` (bilinear, antialias) as
  two separable weight products, width first, each rounded to uint8 like PIL.
* The parity default is the **exact** fixed-point resize. The JAX package
  accumulates it in int32; CUDA has no int32 matmul, so here it runs in
  float64. Every product and partial sum is an integer below
  255 * 2**22 * taps < 2**53, so float64 is exact in any summation order and
  ``floor((y + 2**21) / 2**22)`` equals PIL's ``(y + 2**21) >> 22`` bit for
  bit. float32 and TF32 are not exact and are not used for it.
* The float32 resize (``exact=False``) is the speed contract: at most one
  uint8 level off PIL on rounding ties.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

_PREC_BITS = 22  # PIL PRECISION_BITS for 8-bit images


@functools.lru_cache(maxsize=64)
def _pil_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) triangle-filter matrix identical to PIL's bilinear.

    PIL (ImagingResampleHorizontal): center = (i + 0.5) * scale; support =
    filter.support * filterscale where filterscale = max(scale, 1); weights
    w(j) = triangle((j + 0.5 - center) / filterscale), normalized to sum 1.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # triangle filter support = 1
    precision = 1 << _PREC_BITS
    mat = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        w = (xs + 0.5 - center) / filterscale
        w = np.clip(1.0 - np.abs(w), 0.0, None)
        s = w.sum()
        if s > 0:
            # Quantize like PIL's fixed-point coefficients.
            mat[i, xmin:xmax] = np.round(w / s * precision) / precision
    return mat.astype(np.float32)


def pil_resize_batch(
    x: torch.Tensor, out_hw: tuple[int, int], emulate_uint8: bool = True, exact: bool = False
) -> torch.Tensor:
    """Resize a (B, H, W, C) float32 batch with PIL bilinear-antialias semantics.

    With ``emulate_uint8`` each separable pass rounds half up and clips to
    [0, 255], like PIL's per-pass uint8 storage. With ``exact`` as well, the
    passes accumulate PIL's fixed-point coefficients in float64 (see the
    module docstring) and the result is bit-identical to PIL.
    """
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    wh_np = _pil_bilinear_weights(h, oh)  # (oh, h)
    ww_np = _pil_bilinear_weights(w, ow)  # (ow, w)

    if exact and emulate_uint8:
        prec = float(1 << _PREC_BITS)
        half = float(1 << (_PREC_BITS - 1))
        kh = torch.from_numpy(np.round(wh_np.astype(np.float64) * prec)).to(x.device)
        kw = torch.from_numpy(np.round(ww_np.astype(np.float64) * prec)).to(x.device)
        v = x.to(torch.float64)
        y = torch.einsum("ow,bhwc->bhoc", kw, v)
        y = torch.clamp(torch.floor((y + half) / prec), 0.0, 255.0)
        y = torch.einsum("oh,bhwc->bowc", kh, y)
        y = torch.clamp(torch.floor((y + half) / prec), 0.0, 255.0)
        return y.to(torch.float32)

    # Horizontal pass first (PIL resizes width then height).
    wh = torch.from_numpy(wh_np).to(x.device)
    ww = torch.from_numpy(ww_np).to(x.device)
    y = torch.einsum("ow,bhwc->bhoc", ww, x)
    if emulate_uint8:
        y = torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)
    y = torch.einsum("oh,bhwc->bowc", wh, y)
    if emulate_uint8:
        y = torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)
    return y


def yuv420_to_rgb(packed: torch.Tensor) -> torch.Tensor:
    """Rebuild RGB from the planar YUV 4:2:0 wire format, on the batch's device.

    Inverse of native.rgb_to_yuv420: ``packed`` is (B, H*3/2, W) uint8, Y plane
    rows [0, H), then chroma rows holding Cb | Cr side by side at (H/2, W/2).
    Chroma upsamples with ``jax.image.resize``'s linear kernel (half-pixel
    centres, ``ops/resize.py``), then the BT.601 full-range inverse, rounded
    and clipped to [0, 255] float32 so that what follows sees uint8-exact
    values. Used when WSINSIGHT_WIRE=yuv420 ships patches at 1.5 B/px; lossy
    in chroma, so opt-in.
    """
    from .resize import resize_axis

    _, rows, w = packed.shape
    h = rows * 2 // 3
    cw = w // 2
    y = packed[:, :h, :].to(torch.float32)
    chroma = packed[:, h:, :].to(torch.float32)

    def upsample(plane: torch.Tensor) -> torch.Tensor:
        return resize_axis(resize_axis(plane - 128.0, 1, h), 2, w)

    cb = upsample(chroma[:, :, :cw])
    cr = upsample(chroma[:, :, cw:])
    rgb = torch.stack(
        [
            y + 1.402 * cr,
            y - 0.344136 * cb - 0.714136 * cr,
            y + 1.772 * cb,
        ],
        dim=-1,
    )
    return torch.clamp(torch.round(rgb), 0.0, 255.0)


@dataclass(frozen=True)
class TransformSpec:
    """Resolved transform pipeline for a model config.

    Mirrors the reference's config-driven whitelist (reference:
    modellib/transforms.py:22-38). ``size`` of None means no resize.
    """

    size: tuple[int, int] | None = None
    mean: tuple[float, ...] | None = None
    std: tuple[float, ...] | None = None
    scale: tuple[float, float] | None = None  # (lower, upper) min-max rescale
    to_tensor: bool = True
    # Bit-exact PIL fixed-point resize (float64 accumulation here). The f32
    # path can land ~0.03-3% of pixels one uint8 level off on rounding ties.
    exact_resize: bool = True

    @classmethod
    def from_config(cls, transform_list: Sequence[Any]) -> "TransformSpec":
        """Build from a model-config transform list (dicts or objects with
        .name/.arguments)."""
        size = mean = std = scale = None
        to_tensor = False
        for t in transform_list or []:
            name = t["name"] if isinstance(t, dict) else t.name
            args = (t.get("arguments") if isinstance(t, dict) else t.arguments) or {}
            if name == "Resize":
                s = args.get("size")
                size = (s, s) if isinstance(s, int) else tuple(s)
            elif name == "ToTensor":
                to_tensor = True
            elif name == "Normalize":
                mean = tuple(args.get("mean"))
                std = tuple(args.get("std"))
            elif name == "Scale":
                scale = (float(args.get("lower", 0.0)), float(args.get("upper", 1.0)))
            else:
                raise KeyError(f"unknown transform '{name}'")
        return cls(size=size, mean=mean, std=std, scale=scale, to_tensor=to_tensor)


def make_preprocess_fn(
    spec: TransformSpec, compute_dtype: torch.dtype = torch.float32
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a (B, H, W, 3) uint8 -> (B, oh, ow, 3) ``compute_dtype`` function."""

    def fn(batch_u8: torch.Tensor) -> torch.Tensor:
        x = batch_u8.to(torch.float32)
        if spec.size is not None:
            x = pil_resize_batch(x, spec.size, emulate_uint8=True, exact=spec.exact_resize)
        if spec.to_tensor:
            x = x * (1.0 / 255.0)
        if spec.scale is not None:
            lower, upper = spec.scale
            x = x - torch.amin(x, dim=(1, 2, 3), keepdim=True)
            mx = torch.amax(x, dim=(1, 2, 3), keepdim=True)
            # guarded div: a constant patch (blank glass) would otherwise
            # emit NaN for the whole image and poison its CSV row
            x = x / torch.clamp(mx, min=1e-8)
            x = x * (upper - lower) + lower
        if spec.mean is not None:
            mean = torch.tensor(spec.mean, dtype=torch.float32, device=x.device)
            std = torch.tensor(spec.std, dtype=torch.float32, device=x.device)
            x = (x - mean) / std
        return x.to(compute_dtype)

    return fn
