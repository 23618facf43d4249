"""The patch-classification engine: preprocess -> forward -> probabilities.

Counterpart of ``ClassifierEngine`` in wsinsight_tpu/engine/runner.py, with
the same surface (``spec``, ``n_devices``, ``pad_batch``, ``put``,
``dispatch``, ``run_batch``, ``set_stains``). ``run_inference`` builds one per
run and calls it for each batch, two batches deep::

    pending = deque()
    for images in batches:
        pending.append(engine.dispatch(engine.put(images)))
        if len(pending) > 2:
            probs = pending.popleft().cpu().numpy()

PyTorch runs eagerly, so the step is a plain method; ``dispatch`` enqueues it
on the current CUDA stream and returns without waiting.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..models import create_model
from ..ops.fused_preprocess import make_fused_preprocess_fn
from ..ops.preprocess import TransformSpec, make_preprocess_fn
from ..parallel.mesh import pad_to_multiple, resolve_device
from ..zoo import ModelHandle


def _refuse_unported_options() -> None:
    """Options of the JAX engine this slice does not port yet."""
    if os.getenv("WSINSIGHT_WIRE", "").lower() == "yuv420":
        raise NotImplementedError("WSINSIGHT_WIRE=yuv420 is not yet ported to torch")
    if os.getenv("WSINSIGHT_HOST_RESIZE", "0") not in ("0", ""):
        raise NotImplementedError("WSINSIGHT_HOST_RESIZE is not yet ported to torch")
    if os.getenv("WSINSIGHT_PRECISION"):
        raise NotImplementedError("WSINSIGHT_PRECISION is not yet ported to torch")


class ClassifierEngine:
    """(preprocess -> forward -> probs) step on one device.

    Parity mode (the default) computes in float32 with TF32 off for both
    matmuls and cuDNN convolutions: this constructor sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` for the process, since
    cuDNN's default TF32 convolutions break the 1e-3 probability budget. Its
    resize is the exact PIL fixed-point one (float64 accumulation).

    ``mixed_precision`` runs the model in bfloat16 under autocast and the
    float32-weight resize, on the K1 kernel, which writes bfloat16.

    K1 (``ops/fused_preprocess``) is on by default wherever its float32
    resize already is the contract (mixed precision);
    ``WSINSIGHT_PALLAS_PREPROCESS=1`` forces it for parity too (<= 1 uint8
    level of resize drift) and ``=0`` disables it everywhere, as in the JAX
    engine.
    """

    def __init__(
        self,
        model_info: ModelHandle,
        mixed_precision: bool = False,
        w_est: np.ndarray | None = None,
        w_def: np.ndarray | None = None,
        max_devices: int | None = None,
        device: str | torch.device | None = None,
    ):
        if w_est is not None or w_def is not None:
            raise NotImplementedError("stain normalization is not yet ported to torch")
        _refuse_unported_options()
        self.device = resolve_device(device)
        self.n_devices = 1  # one device in this slice; max_devices has nothing to cut
        cfg = model_info.config
        compute_dtype = torch.bfloat16 if mixed_precision else torch.float32
        if not mixed_precision:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        model = create_model(cfg.architecture, cfg.num_classes, dtype=compute_dtype)
        model.load_state_dict(model_info.load_state_dict(), strict=True)
        self.model = model.to(self.device, memory_format=torch.channels_last)

        self.spec = TransformSpec.from_config(cfg.transform)
        if mixed_precision:
            # Speed mode: the float32-weight resize (<= 1 uint8 level of drift).
            self.spec = dataclasses.replace(self.spec, exact_resize=False)
        preprocess = make_preprocess_fn(self.spec, compute_dtype)
        fused_env = os.getenv("WSINSIGHT_PALLAS_PREPROCESS", "")
        use_fused = fused_env != "0" if fused_env else not self.spec.exact_resize
        if use_fused:
            fused = make_fused_preprocess_fn(self.spec, out_dtype=compute_dtype)
            if fused is not None:
                preprocess = fused
        self._preprocess = preprocess

    def set_stains(self, w_est: np.ndarray, w_def: np.ndarray) -> None:
        raise NotImplementedError("stain normalization is not yet ported to torch")

    def pad_batch(self, n: int) -> int:
        """Global batch size: requested size rounded up to the device count."""
        return pad_to_multiple(n, self.n_devices)

    def _step(self, batch_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = self._preprocess(batch_u8)  # (B, oh, ow, 3) NHWC
            # NHWC permuted to NCHW is channels_last, without a copy.
            logits = self.model(x.permute(0, 3, 1, 2))
            if logits.dim() > 1 and logits.shape[1] > 1:
                return torch.softmax(logits, dim=1)
            return torch.sigmoid(logits[:, 0])[:, None]

    def put(self, images_u8: np.ndarray) -> torch.Tensor:
        """Host -> device copy of a (B, H, W, 3) uint8 batch: pinned and
        non-blocking on CUDA, so it returns before the copy ends."""
        host = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def dispatch(self, images: torch.Tensor) -> torch.Tensor:
        """Enqueue the step and return the device tensor of probabilities
        without synchronising, so the next batch's decode and copy overlap
        this batch's compute."""
        return self._step(images)

    def run_batch(self, images_u8: np.ndarray, n_valid: int) -> np.ndarray:
        return self._step(self.put(images_u8)).cpu().numpy()[:n_valid]
