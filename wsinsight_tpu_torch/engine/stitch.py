"""Slide-scale canvas stitcher for single-cell models: the device half.

Counterpart of wsinsight_tpu/engine/stitch.py. Per batch, on the model's
device: softmax, bilinear resize of the patch maps to slide space, HV scaling
by model_mpp/slide_mpp and per-pixel TP renormalisation
(``make_map_postprocess``); then one transfer of the resized maps, in the
chosen dtype, into host canvases (``scatter``). The host finalize, the tiled
watershed instance extraction, is not ported yet (``ROADMAP.md``, Queue 1,
item 2).

Memory note: the canvases are (H, W) f32 + (H, W, 2) f32 + (H, W, K) f32,
(12+4K) bytes/px; above WSINSIGHT_CANVAS_MEMMAP_BYTES they are backed by
disk memmaps.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.resize import resize_axis

TRANSFER_DTYPES = ("quantized", "bfloat16", "float32")


def make_map_postprocess(slide_patch_size: int, alpha: float):
    """Device half of the cell map pipeline.

    (B,2,h,w) NP logits, (B,2,h,w) HV, (B,K,h,w) TP logits (the model's
    channel-first output) to channel-LAST float32 slide-space maps: NP
    (B,s,s), HV (B,s,s,2) scaled by alpha = model_mpp/slide_mpp, TP
    (B,s,s,K) renormalised per pixel. The resize is ``jax.image.resize``'s
    bilinear one (half-pixel centres, antialiased when it shrinks).
    """
    s = slide_patch_size

    def resize(x: torch.Tensor) -> torch.Tensor:
        return resize_axis(resize_axis(x, -2, s), -1, s)

    def core(np_logits, hv, tp_logits):
        np_prob = torch.softmax(np_logits.float(), dim=1)[:, 1]  # (B,h,w)
        tp_prob = torch.softmax(tp_logits.float(), dim=1)
        np_res = resize(np_prob)
        hv_res = (resize(hv.float()) * alpha).permute(0, 2, 3, 1)
        tp_res = resize(tp_prob)
        tp_res = (tp_res / (tp_res.sum(dim=1, keepdim=True) + 1e-8)).permute(0, 2, 3, 1)
        return np_res, hv_res, tp_res

    return core


class TileRemapStitcher:
    """Accumulate per-patch prediction maps into slide canvases."""

    def __init__(
        self,
        n_classes: int,
        slide_width: int,
        slide_height: int,
        slide_patch_size: int,
        slide_halo_size: int,
        slide_mpp: float,
        model_mpp: float,
        min_object_size: int = 20,
        memmap_above_bytes: int | None = None,
        transfer_dtype: str | None = None,
    ):
        # Map-transfer dtype: "quantized" (default) sends probabilities as
        # uint8 (step 1/255) and HV as bf16, ~4.5x fewer bytes than f32 at
        # K=6; "bfloat16" halves f32; "float32" is exact. Override with
        # WSINSIGHT_CELL_TRANSFER.
        if transfer_dtype is None:
            transfer_dtype = os.getenv("WSINSIGHT_CELL_TRANSFER", "quantized")
        if transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"transfer dtype {transfer_dtype!r} not in {TRANSFER_DTYPES}")
        self.transfer_dtype = transfer_dtype
        self.n_classes = n_classes
        self.slide_width = slide_width
        self.slide_height = slide_height
        self.slide_patch_size = slide_patch_size
        self.slide_halo_size = slide_halo_size
        self.alpha = model_mpp / slide_mpp
        self.min_object_size = int(min_object_size)
        if memmap_above_bytes is None:
            memmap_above_bytes = int(
                os.getenv("WSINSIGHT_CANVAS_MEMMAP_BYTES", 32 * (1 << 30))
            )
        total_bytes = slide_height * slide_width * (12 + 4 * n_classes)
        self._tmpdir = None
        shapes = {
            "np": (slide_height, slide_width),
            "hv": (slide_height, slide_width, 2),
            "tp": (slide_height, slide_width, n_classes),
        }
        if total_bytes > memmap_above_bytes:
            import tempfile

            self._tmpdir = tempfile.mkdtemp(prefix="wsinsight_canvas_")
            canvases = {
                k: np.memmap(os.path.join(self._tmpdir, f"{k}.dat"), dtype=np.float32,
                             mode="w+", shape=shape)
                for k, shape in shapes.items()
            }
        else:
            canvases = {k: np.zeros(shape, np.float32) for k, shape in shapes.items()}
        self.np_map, self.hv_map, self.tp_map = canvases["np"], canvases["hv"], canvases["tp"]
        self._core = make_map_postprocess(slide_patch_size, self.alpha)

    def close(self) -> None:
        """Release memmap backing files, if any."""
        if self._tmpdir is not None:
            import shutil

            self.np_map = self.hv_map = self.tp_map = None  # type: ignore[assignment]
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    # ------------------------------------------------------------------
    def device_postprocess(self, pred_dict: dict):
        """Enqueue the device half (softmax / resize / HV scale / transfer
        dtype) and return device tensors without synchronising, so the
        caller can overlap the next forward with this batch's scatter.

        pred_dict takes either key convention, {np, hv, tp} or
        {nuclei_binary_map, hv_map, nuclei_type_map}, of (B, C, h, w)
        tensors."""
        np_logits = pred_dict.get("np", pred_dict.get("nuclei_binary_map"))
        hv = pred_dict.get("hv", pred_dict.get("hv_map"))
        tp_logits = pred_dict.get("tp", pred_dict.get("nuclei_type_map"))
        if np_logits is None or hv is None or tp_logits is None:
            raise KeyError(f"prediction maps missing from {sorted(pred_dict)}")
        with torch.inference_mode():
            np_res, hv_res, tp_res = self._core(
                torch.as_tensor(np_logits), torch.as_tensor(hv), torch.as_tensor(tp_logits)
            )
            if self.transfer_dtype == "quantized":
                # torch.round rounds half to even, as jnp.round does.
                return (
                    torch.round(np_res * 255.0).to(torch.uint8),
                    hv_res.to(torch.bfloat16),
                    torch.round(tp_res * 255.0).to(torch.uint8),
                )
            out_dt = torch.bfloat16 if self.transfer_dtype == "bfloat16" else torch.float32
            return np_res.to(out_dt), hv_res.to(out_dt), tp_res.to(out_dt)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """One device -> host copy in the transfer dtype, then float32 (or
        uint8) numpy on the host."""
        t = t.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def scatter(self, maps, batch_coords: np.ndarray, n_valid: int | None = None) -> None:
        """Fetch one post-processed batch and write it into the host canvases.

        batch_coords is (B, 4) [minx, miny, w, h] in slide coordinates.
        """
        np_res, hv_res, tp_res = (self._host(m) for m in maps)
        if np_res.dtype == np.uint8:  # quantized transfer: dequantize on host
            np_res = np_res.astype(np.float32) / 255.0
            tp_res = tp_res.astype(np.float32) / 255.0
        s = self.slide_patch_size
        coords = np.asarray(batch_coords, dtype=np.int64)[:, :2] + self.slide_halo_size
        n = np_res.shape[0] if n_valid is None else min(n_valid, np_res.shape[0])
        for i in range(n):
            x0, y0 = int(coords[i, 0]), int(coords[i, 1])
            x1, y1 = x0 + s, y0 + s
            cx0, cy0 = max(0, x0), max(0, y0)
            cx1, cy1 = min(self.slide_width, x1), min(self.slide_height, y1)
            if cx1 <= cx0 or cy1 <= cy0:
                continue
            tx0, ty0 = cx0 - x0, cy0 - y0
            tx1, ty1 = tx0 + (cx1 - cx0), ty0 + (cy1 - cy0)
            self.np_map[cy0:cy1, cx0:cx1] = np_res[i, ty0:ty1, tx0:tx1]
            self.hv_map[cy0:cy1, cx0:cx1, :] = hv_res[i, ty0:ty1, tx0:tx1, :]
            self.tp_map[cy0:cy1, cx0:cx1, :] = tp_res[i, ty0:ty1, tx0:tx1, :]

    def accumulate_batch(
        self, pred_dict: dict, batch_coords: np.ndarray, n_valid: int | None = None
    ) -> None:
        """Device post-process one batch and scatter it (synchronous form)."""
        self.scatter(self.device_postprocess(pred_dict), batch_coords, n_valid)

    def finalize(self, *args, **kwargs):
        """Tiled watershed instance extraction: not ported yet."""
        raise NotImplementedError(
            "TileRemapStitcher.finalize (hv_postproc, watershed) is not yet ported to"
            " torch (ROADMAP.md, Queue 1, item 2: the cell path's host half)"
        )
