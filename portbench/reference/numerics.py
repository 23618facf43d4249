"""Matmul and convolution operands in the reference's precision."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def cast(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` in float32, or rounded to float8 e4m3 under a per-tensor scale
    that maps its largest magnitude to FP8_MAX (the usual fp8 inference
    recipe) and brought back to float32."""
    t = t.float()
    if precision == "float32":
        return t
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
