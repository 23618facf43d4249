"""StarDist 2D nucleus pre-detection in torch.

Counterpart of wsinsight_tpu/models/stardist.py. The object-based
(non-end2end) patch mode runs StarDist's pretrained ``2D_versatile_he`` over
the whole image blockwise (reference: wsinsight/patchlib/pipeline.py:299-355:
csbdeep percentile normalize, predict_instances_big(block_size=4096,
min_overlap=128, context=128)). This module has:

* a U-Net mirroring the released 2D_versatile_he graph layer for layer
  (grid (2, 2) pooled stem, csbdeep unet_block with depth 3 / base 32 / 2
  convs per level where the middle and up levels HALVE the width on their
  last conv, a 128-wide ``features`` conv, sigmoid ``prob`` and linear
  ``dist`` heads with 32 rays), with the Keras layer names, so the Keras
  file converts verbatim (``convert.convert_stardist_keras_h5``);
* tiled inference with context overlap, on the card unless the caller asks
  for the CPU, in float32 with TF32 off;
* star-polygon candidates and the greedy NMS on the host (numpy and plain
  Python, copies of the JAX package's);
* percentile normalization (csbdeep ``normalize(img, pmin, pmax)``).

Each step is a ``utils.profiling.hot_stage`` (``stardist.normalize``,
``.copy_in``, ``.forward``, ``.copy_out``, ``.candidates``, ``.nms``; the
plan adds ``.read``), timed when WSINSIGHT_STREAM_PROFILE=1.

Weights: the released Keras file (``stardist_2D_versatile_he.h5``, read with
h5py) or a flax msgpack (``stardist_2D_versatile_he.msgpack``) under
``$WSINSIGHT_MODEL_DIR``, or ``$KERAS_HOME/models/StarDist2D/
2D_versatile_he/weights_best.h5`` (where TF/StarDist caches the download).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import hot_stage

logger = logging.getLogger(__name__)

N_RAYS = 32
# 2D_versatile_he predicts prob/dist on a 2x-subsampled grid.
GRID = 2


class StarDistUNet(nn.Module):
    """The 2D_versatile_he graph. Module names are the Keras layer names
    (down_level_N_no_I / middle_I / up_level_N_no_I / features / prob /
    dist); the grid stem's anonymous Keras convs are stem_conv_0/1.

    ``forward`` takes NHWC (B, H, W, 3) normalized float images, H and W
    divisible by 16, and returns (prob (B, H/2, W/2, 1), dist (B, H/2, W/2,
    N_RAYS)): prob through a sigmoid, dist linear, in pixels at the FULL
    input resolution. Inside, NCHW in channels_last memory."""

    def __init__(self, base_filters: int = 32, depth: int = 3, n_conv_per_depth: int = 2,
                 n_rays: int = N_RAYS, features_after: int = 128):
        super().__init__()
        self.depth, self.n_conv = depth, n_conv_per_depth
        base = base_filters
        cin = 3

        def conv3(name: str, width: int) -> None:
            nonlocal cin
            setattr(self, name, nn.Conv2d(cin, width, 3, padding=1))  # SAME, with bias
            cin = width

        for i in range(n_conv_per_depth):
            conv3(f"stem_conv_{i}", base)
        for level in range(depth):
            for i in range(n_conv_per_depth):
                conv3(f"down_level_{level}_no_{i}", base * 2**level)
        # the middle runs at 2**depth width, its LAST conv drops to
        # 2**(depth-1) so the concat with the deepest skip is balanced ...
        for i in range(n_conv_per_depth - 1):
            conv3(f"middle_{i}", base * 2**depth)
        conv3(f"middle_{n_conv_per_depth - 1}", base * 2 ** max(0, depth - 1))
        # ... and each up level likewise halves on its last conv
        for level in reversed(range(depth)):
            cin += base * 2**level  # the skip's channels
            for i in range(n_conv_per_depth - 1):
                conv3(f"up_level_{level}_no_{i}", base * 2**level)
            conv3(f"up_level_{level}_no_{n_conv_per_depth - 1}", base * 2 ** max(0, level - 1))
        conv3("features", features_after)
        self.prob = nn.Conv2d(features_after, 1, 1)
        self.dist = nn.Conv2d(features_after, n_rays, 1)

    def _relu_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, name)(x))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_conv):
            x = self._relu_conv(f"stem_conv_{i}", x)
        x = F.max_pool2d(x, 2)
        skips = []
        for level in range(self.depth):
            for i in range(self.n_conv):
                x = self._relu_conv(f"down_level_{level}_no_{i}", x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        for i in range(self.n_conv):
            x = self._relu_conv(f"middle_{i}", x)
        for level in reversed(range(self.depth)):
            x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skips[level]], 1)
            for i in range(self.n_conv):
                x = self._relu_conv(f"up_level_{level}_no_{i}", x)
        feat = self._relu_conv("features", x)
        prob = torch.sigmoid(self.prob(feat))
        return prob.permute(0, 2, 3, 1), self.dist(feat).permute(0, 2, 3, 1)


def normalize_percentile(img: np.ndarray, pmin: float, pmax: float) -> np.ndarray:
    """csbdeep.utils.normalize: (x - P_pmin) / (P_pmax - P_pmin).

    Percentiles are GLOBAL over the whole array (csbdeep's axis=None
    default, which is what the reference pipeline feeds the checkpoint).
    """
    x = img.astype(np.float32)
    lo = np.percentile(x, pmin)
    hi = np.percentile(x, pmax)
    return (x - lo) / max(hi - lo, 1e-20)


def _ray_candidates(prob: np.ndarray, dist: np.ndarray, prob_thresh: float, grid: int = GRID):
    """Candidate centres / scores / per-ray lengths from the per-pixel maps.

    Rays, not materialised polygons: a dense whole-slide candidate set at
    (M, R, 2) float64 polygons costs GBs; (M, R) float32 ray lengths are 4x
    smaller and polygons are only built for the NMS survivors.
    """
    ys, xs = np.nonzero(prob > prob_thresh)
    if len(ys) == 0:
        return (
            np.zeros(0, np.float32),
            np.zeros((0, 2), np.float32),
            np.zeros((0, N_RAYS), np.float32),
        )
    scores = prob[ys, xs].astype(np.float32)
    # linear dist head: negative rays are untrained noise, not geometry
    rays = np.maximum(dist[ys, xs].astype(np.float32), 0.0)  # (M, R)
    centers = np.stack([xs * grid, ys * grid], axis=1).astype(np.float32)
    return scores, centers, rays


def _rays_to_polys(centers: np.ndarray, rays: np.ndarray) -> np.ndarray:
    """(M, 2) centres + (M, R) ray lengths -> (M, R, 2) xy star polygons."""
    phis = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    dx = np.cos(phis)[None, :] * rays
    dy = np.sin(phis)[None, :] * rays
    return np.stack([centers[:, None, 0] + dx, centers[:, None, 1] + dy], axis=2)


def _nms(scores: np.ndarray, centers: np.ndarray, rays: np.ndarray, nms_thresh: float = 0.4):
    """Greedy NMS on mean-radius disk overlap, spatially binned.

    Candidates are compared only against kept neighbours within the maximum
    suppression distance (2 * nms_thresh * r_max), found via a uniform grid —
    the decisions are identical to the all-pairs greedy scan, but dense
    whole-slide candidate sets (10^5-10^6 per slide) stay tractable instead
    of O(N x kept) interpreter work.
    """
    if len(scores) == 0:
        return []
    order = np.argsort(-scores, kind="stable")
    mean_r = np.maximum(rays.mean(axis=1), 1.0)
    cell = float(max(1.0, 2.0 * nms_thresh * mean_r.max()))
    bins: dict[tuple[int, int], list[int]] = {}
    kept: list[int] = []
    for i in order:
        cx, cy = float(centers[i, 0]), float(centers[i, 1])
        r = mean_r[i]
        bx, by = int(cx // cell), int(cy // cell)
        ok = True
        for nx in (bx - 1, bx, bx + 1):
            for ny in (by - 1, by, by + 1):
                for j in bins.get((nx, ny), ()):
                    if (
                        np.hypot(cx - centers[j, 0], cy - centers[j, 1])
                        < nms_thresh * (r + mean_r[j])
                    ):
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            kept.append(int(i))
            bins.setdefault((bx, by), []).append(int(i))
    return kept


class StarDist2D:
    """Tiled StarDist inference on one device (the card unless ``device``
    or WSINFER_FORCE_CPU asks for the CPU).

    ``state_dict`` is the port's (``StarDistUNet``'s names); None loads the
    released weights (module docstring). The forward runs in float32 with
    TF32 off, so the card and the CPU make the same candidates."""

    def __init__(self, state_dict: dict | None = None, prob_thresh: float = 0.5,
                 nms_thresh: float = 0.4, device: str | torch.device | None = None):
        from ..parallel.mesh import resolve_device

        self.device = resolve_device(device)
        self.prob_thresh = prob_thresh
        self.nms_thresh = nms_thresh
        model = StarDistUNet()
        model.load_state_dict(state_dict if state_dict is not None
                              else self._load_default_state_dict(), strict=True)
        self.model = model.eval().to(self.device, memory_format=torch.channels_last)

    @staticmethod
    def _load_default_state_dict() -> dict:
        from ..zoo import WeightsNotFoundError
        from .convert import convert_stardist_keras_h5, flax_params_to_state_dict, load_flax_msgpack

        candidates: list[Path] = []
        model_dir = os.getenv("WSINSIGHT_MODEL_DIR")
        if model_dir:
            candidates += [
                Path(model_dir) / "stardist_2D_versatile_he.msgpack",
                Path(model_dir) / "stardist_2D_versatile_he.h5",
            ]
        # where TF/StarDist caches the official download (KERAS_HOME is part
        # of the reference's documented surface, README.md:96-99)
        keras_home = Path(os.getenv("KERAS_HOME", Path.home() / ".keras"))
        candidates.append(
            keras_home / "models" / "StarDist2D" / "2D_versatile_he" / "weights_best.h5"
        )
        for cand in candidates:
            if cand.exists():
                if cand.suffix == ".msgpack":
                    return flax_params_to_state_dict(load_flax_msgpack(cand))
                return convert_stardist_keras_h5(cand)
        raise WeightsNotFoundError(
            "StarDist '2D_versatile_he' weights not found. Place the released"
            " Keras weights (weights_best.h5) at"
            " $WSINSIGHT_MODEL_DIR/stardist_2D_versatile_he.h5 (converted"
            " automatically, no TensorFlow needed), convert them once with"
            " scripts/convert_keras_stardist.py to"
            " stardist_2D_versatile_he.msgpack, or let $KERAS_HOME/models/"
            "StarDist2D/2D_versatile_he/weights_best.h5 be found."
        )

    def predict_tile(self, tile: np.ndarray):
        """tile: (H, W, 3) normalized float -> grid-subsampled maps
        (prob (H/g, W/g), dist (H/g, W/g, R)) as numpy; ray units are
        FULL-RES px."""
        from ..engine.runner import tf32_flags

        x = torch.from_numpy(np.ascontiguousarray(tile[None], dtype=np.float32))
        with torch.inference_mode(), tf32_flags(False):
            with hot_stage("stardist.copy_in"):
                x = x.to(self.device)
            with hot_stage("stardist.forward"):
                prob, dist = self.model(x)
                if x.is_cuda:  # where the copy out would wait: the stages split here
                    torch.cuda.synchronize(x.device)
            with hot_stage("stardist.copy_out"):
                return prob[0, :, :, 0].cpu().numpy(), dist[0].cpu().numpy()

    def predict_instances_big(
        self,
        img: np.ndarray,
        block_size: int = 4096,
        context: int = 128,
        **_unused,
    ) -> List[np.ndarray]:
        """Blockwise prediction over a large normalized image -> list of (R,2)
        polygons in image coordinates (reference contract: pipeline.py:315-344).
        Logs the counts (blocks, candidates, those in the blocks' interiors,
        kept), also as the record's ``stardist_counts``."""
        h, w = img.shape[:2]
        all_scores: list[np.ndarray] = []
        all_centers: list[np.ndarray] = []
        all_rays: list[np.ndarray] = []
        counts = {"blocks": 0, "candidates": 0, "interior": 0, "kept": 0}
        step = block_size
        for y0 in range(0, h, step):
            for x0 in range(0, w, step):
                py0 = max(0, y0 - context)
                px0 = max(0, x0 - context)
                py1 = min(h, y0 + step + context)
                px1 = min(w, x0 + step + context)
                tile = img[py0:py1, px0:px1]
                # pad to a multiple of 16: grid pool (2) x depth-3 pools (8)
                th = -(-tile.shape[0] // 16) * 16
                tw = -(-tile.shape[1] // 16) * 16
                padded = np.zeros((th, tw, tile.shape[2]), np.float32)
                padded[: tile.shape[0], : tile.shape[1]] = tile
                prob, dist = self.predict_tile(padded)
                counts["blocks"] += 1
                # maps are grid-subsampled; crop the padding at grid scale
                gh = -(-tile.shape[0] // GRID)
                gw = -(-tile.shape[1] // GRID)
                prob = prob[:gh, :gw]
                dist = dist[:gh, :gw]
                # keep candidates whose centers fall in the interior block
                with hot_stage("stardist.candidates"):
                    scores, centers, rays = _ray_candidates(prob, dist, self.prob_thresh)
                counts["candidates"] += len(scores)
                if len(scores) == 0:
                    continue
                gx = centers[:, 0] + px0
                gy = centers[:, 1] + py0
                inside = (gx >= x0) & (gx < min(w, x0 + step)) & (gy >= y0) & (gy < min(h, y0 + step))
                if not inside.any():
                    continue
                all_scores.append(scores[inside])
                all_centers.append(np.stack([gx[inside], gy[inside]], axis=1))
                all_rays.append(rays[inside])
        polys: List[np.ndarray] = []
        if all_scores:
            scores = np.concatenate(all_scores)
            centers = np.concatenate(all_centers)
            rays = np.concatenate(all_rays)
            with hot_stage("stardist.nms"):
                kept = _nms(scores, centers, rays, self.nms_thresh)
            # polygons materialised for the survivors only
            polys = list(_rays_to_polys(centers[kept], rays[kept]).astype(np.float32))
            counts.update(interior=len(scores), kept=len(kept))
        logger.info("StarDist: %(blocks)d blocks, %(candidates)d candidates, %(interior)d in"
                    " the blocks' interiors, %(kept)d kept by the NMS", counts,
                    extra={"stardist_counts": counts})
        return polys


def predict_nuclei_big(
    img: np.ndarray,
    pmin: float = 1.0,
    pmax: float = 99.8,
    state_dict: dict | None = None,
    block_size: int = 4096,
    context: int = 128,
) -> List[np.ndarray]:
    """Normalize + blockwise StarDist prediction -> list of (R,2) xy polygons."""
    with hot_stage("stardist.normalize"):
        norm = normalize_percentile(img, pmin, pmax)
    model = StarDist2D(state_dict=state_dict)
    return model.predict_instances_big(norm, block_size=block_size, context=context)
