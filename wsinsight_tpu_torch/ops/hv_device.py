"""Device half of the HV separation-energy stage, in torch ops.

Counterpart of the energy half of wsinsight_tpu/ops/hv_device.py. The most
expensive dense step of nucleus post-processing is the wide Sobel over the
HV field (ksize=21 on 2048^2 finalize tiles — reference:
wsinsight/modellib/tilefuse.py:63-79). That part is foreground-independent:
``energy_raw = max(1 - unit(Sobel_x(unit(h))), 1 - unit(Sobel_y(unit(v))))``
only depends on the HV maps, so it can run batched on the card while the
host keeps the sequential tail (hole fill, labelling, watershed).

The host-canvas stitcher runs it when ``WSINSIGHT_DEVICE_RIDGE=1``, on the
device it is given, and never moves it to another one; the banded streaming
engine (``engine/stream_cells.py``) runs it on every tile window, with
``make_blur3_core``'s integer basin blur when it proposes the watershed's
markers on the device. Numerics are pinned to the cv2 path by tests (the
taps of ``cv2.getDerivKernels(1, 0, ksize=21)``, the same REFLECT_101
border).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _sobel_taps(ksize: int = 21) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(derivative, smoothing) 1-D taps of cv2.getDerivKernels(1, 0, ksize):
    binomial integers, exact in float32."""
    import cv2

    kx, ky = cv2.getDerivKernels(1, 0, ksize=ksize)
    return (tuple(float(t) for t in kx.ravel().astype(np.float64)),
            tuple(float(t) for t in ky.ravel().astype(np.float64)))


def make_energy_core(ksize: int = 21):
    """(B, H, W, 2) HV tensor -> (B, H, W) float32 raw separation energy,
    each image normalised on its own, on the tensor's device."""
    deriv, smooth = _sobel_taps(ksize)
    half = ksize // 2

    def _conv1d(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
        # x: (B, H, W); correlate along `axis` (1 rows, 2 columns) with a
        # REFLECT_101 border (torch's "reflect"). Tap-by-tap shifted adds in
        # float32, never conv2d: a TF32 or reordered sum would move the u8
        # energy that the integer basin is built from.
        pad = (half, half, 0, 0) if axis == 2 else (0, 0, half, half)
        xp = F.pad(x[:, None], pad, mode="reflect")[:, 0]
        n = x.shape[axis]
        acc = None
        for j, t in enumerate(taps):
            term = t * xp.narrow(axis, j, n)
            acc = term if acc is None else acc + term
        return acc

    def _unit(x: torch.Tensor) -> torch.Tensor:
        lo = x.amin(dim=(1, 2), keepdim=True)
        span = x.amax(dim=(1, 2), keepdim=True) - lo
        ok = span > 0
        return torch.where(ok, (x - lo) / torch.where(ok, span, torch.ones_like(span)),
                           torch.zeros_like(x))

    def energy(hv: torch.Tensor) -> torch.Tensor:
        hv = hv.to(torch.float32)
        h_dir = _unit(hv[..., 0])
        v_dir = _unit(hv[..., 1])
        # cv2.Sobel(dx=1): derivative along x (columns), smoothing along y
        grad_h = _conv1d(_conv1d(h_dir, deriv, axis=2), smooth, axis=1)
        grad_v = _conv1d(_conv1d(v_dir, smooth, axis=2), deriv, axis=1)
        return torch.maximum(1.0 - _unit(grad_h), 1.0 - _unit(grad_v))

    return energy


def make_blur3_core():
    """(B, H, W) tensor -> (B, H, W) float32 [1,2,1]x[1,2,1] blur with a
    REFLECT_101 border, each image on its own.

    The integer watershed-basin blur (ops/hv_postproc._integer_basin) on the
    device: inputs are integers in [0, 255], so every sum stays at or below
    16 * 255 = 4080 and float32 shifted adds are exact, bit for bit the
    host's integer cv2.sepFilter2D. Never conv2d: a TF32 product keeps 10
    bits and 4080 needs 12."""

    def blur3(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        xp = F.pad(x, (1, 1), mode="reflect")
        r = xp[..., :-2] + 2.0 * xp[..., 1:-1] + xp[..., 2:]
        rp = F.pad(r, (0, 0, 1, 1), mode="reflect")
        return rp[:, :-2] + 2.0 * rp[:, 1:-1] + rp[:, 2:]

    return blur3


def make_energy_fn(ksize: int = 21):
    """(B, H, W, 2) HV tensor -> (B, H, W) raw separation energy, without
    autograd."""
    core = make_energy_core(ksize)

    def fn(hv: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return core(hv)

    return fn


def separation_energy_batched(hv_tiles: np.ndarray, device: str | torch.device) -> np.ndarray:
    """Raw separation energy of a (B, H, W, 2) batch of HV tiles, computed on
    ``device``; returns (B, H, W) float32 numpy."""
    hv = torch.from_numpy(np.ascontiguousarray(hv_tiles, np.float32)).to(device)
    return make_energy_fn()(hv).cpu().numpy()
