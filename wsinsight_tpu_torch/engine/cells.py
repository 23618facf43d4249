"""Single-cell (object-based end2end) inference: the CellViT engine.

Counterpart of ``CellEngine`` in wsinsight_tpu/engine/cells.py, with the
same surface (``config``, ``n_devices``, ``pad_batch``, ``run_batch``) plus
``put`` / ``dispatch`` as in ``ClassifierEngine``. ``run_cell_inference``
drives it one batch deep with the stitcher's device half::

    pending = None
    for batch in batches:
        pred = engine.dispatch(engine.put(batch.images))
        maps = stitcher.device_postprocess(pred)  # enqueued, not waited for
        if pending is not None:
            stitcher.scatter(*pending)  # the previous batch's transfer
        pending = (maps, batch.coords, batch.n_valid)

The slide I/O and the host finalize around it are not ported yet
(``ROADMAP.md``, Queue 1, items 1 and 2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import create_model
from ..ops.preprocess import TransformSpec, make_preprocess_fn
from ..parallel.mesh import pad_to_multiple, resolve_device
from ..zoo import ModelHandle, randomize_cell_model
from .runner import _refuse_unported_options


class CellEngine:
    """(preprocess -> CellViT forward) step on one device.

    Parity mode (the default) computes in float32 with TF32 off for matmuls
    and cuDNN convolutions (set for the process, as ``ClassifierEngine``
    does). ``mixed_precision`` runs the model under bfloat16 autocast. On the
    card every attention core runs the K2 kernel.

    ``init_random`` gives the model ``randomize_cell_model``'s seeded weights
    (``seed``) instead of loading ``model_info``'s checkpoint, so a full-size
    SAM-H needs no file; the same seed gives the same weights on every
    device.
    """

    def __init__(
        self,
        model_info: ModelHandle,
        mixed_precision: bool = False,
        max_devices: int | None = None,
        init_random: bool = False,
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        _refuse_unported_options(classifier=False)
        self.device = resolve_device(device)
        self.n_devices = 1  # one device in this slice; max_devices has nothing to cut
        cfg = model_info.config
        self.config = cfg
        self.mixed_precision = mixed_precision
        compute_dtype = torch.bfloat16 if mixed_precision else torch.float32
        if not mixed_precision:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        model = create_model(cfg.architecture, cfg.num_classes, dtype=compute_dtype,
                             halo_size=cfg.halo_size_pixels, img_size=cfg.patch_size_pixels)
        if init_random:
            randomize_cell_model(model, seed)
        else:
            model.load_state_dict(model_info.load_state_dict(model), strict=True)
        self.model = model.to(self.device)
        self._preprocess = make_preprocess_fn(TransformSpec.from_config(cfg.transform),
                                              compute_dtype)

    def pad_batch(self, n: int) -> int:
        """Global batch size: requested size rounded up to the device count."""
        return pad_to_multiple(n, self.n_devices)

    def _step(self, batch_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.inference_mode():
            return self.model(self._preprocess(batch_u8))

    def put(self, images_u8: np.ndarray) -> torch.Tensor:
        """Host -> device copy of a (B, H, W, 3) uint8 batch: pinned and
        non-blocking on CUDA, so it returns before the copy ends."""
        host = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def dispatch(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """Enqueue the step; returns the device maps without synchronising."""
        return self._step(images)

    def run_batch(self, images_u8: np.ndarray) -> dict[str, torch.Tensor]:
        """(B, P, P, 3) uint8 -> the model's output dict, on the device:
        channel-first float32 maps cropped to the halo interior and the
        tissue logits."""
        return self._step(self.put(images_u8))
