"""HoVer-Net-style nucleus instance extraction from NP/HV maps (host CPU).

Counterpart of wsinsight_tpu/ops/hv_postproc.py (cv2 and numpy; the
watershed is the host library's, ``ops/watershed.py``).

Splits a nucleus-probability map into individual instances using the
horizontal/vertical offset maps, then measures each instance. The numeric
recipe (thresholds, kernel sizes) matches the reference post-processing
(reference: wsinsight/modellib/tilefuse.py:39-174) because downstream
parity depends on it, but the pipeline here is organised as four explicit
stages with vectorised measurement:

  1. foreground     — np >= 0.5, connected components, size filter
  2. boundary energy — where the HV field changes fastest, nuclei touch;
                       large-kernel Sobel on min-max-normalised H and V
  3. seeds          — foreground minus strong-boundary pixels, cleaned
                       (hole fill, elliptic opening) and size-filtered
  4. flood          — marker watershed on the smoothed basin depth

Measurement computes all bounding boxes and per-class mean probabilities in
single vectorised passes over the label image (sorted-pixel grouping +
per-class bincount) rather than per-instance region loops.

The default tail is the EXACT-INTEGER formulation: energy as u8 fixed-point
(e*255) and the basin as an integer [1,2,1]⊗[1,2,1] convolution (see
``_integer_basin``) — order-equivalent to the float Gaussian recipe over u8
energy, one integer filter pass instead of several f32 image passes, and
bit-identical whether evaluated here or in the JAX package's streaming
engine's device window kernel (its engine/stream_cells.py
window_stage_proposal; the port's streaming engine is ROADMAP.md Queue 1
item 6, and ``extract_instance_labels*`` below are its entry points).
``WSINSIGHT_HV_BASIN=f32`` restores the float recipe end-to-end.

Alignment guarantee: the returned bbox / prob / polygon lists are always the
same length — an instance whose contour is degenerate (< 3 vertices) is
dropped from all three. The reference keeps such instances in its bbox and
prob lists while skipping the polygon (tilefuse.py:160-173), which silently
desynchronises the ragged /polygons HDF5 group from the CSV rows; that is a
defect we deliberately do not reproduce (SURVEY.md §2.11 spirit).
"""

from __future__ import annotations

from typing import List, Tuple

import cv2
import numpy as np

from ..utils.profiling import hot_stage as _stage
from .watershed import watershed

try:
    cv2.setNumThreads(1)  # the stitcher threads across tiles already
except Exception:
    pass

# Numeric contract shared with the reference (tilefuse.py:39-103):
_FG_THRESHOLD = 0.5       # nucleus-probability cutoff
_BOUNDARY_THRESHOLD = 0.4  # separation-energy cutoff for seed carving
_BOUNDARY_U8 = 102         # the same cutoff on the u8 wire: 0.4 * 255 exactly
_SOBEL_KSIZE = 21          # large-support gradient of the HV field
_SEED_OPEN_KSIZE = 5       # elliptic opening applied to seed blobs


def _unit_range(x: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 1] as float32 (flat input maps to all-zero)."""
    x = x.astype(np.float32, copy=False)
    lo = float(x.min())
    span = float(x.max()) - lo
    if span <= 0.0:
        return np.zeros_like(x, dtype=np.float32)
    return (x - lo) * (1.0 / span)


def _label_small_filtered(mask_u8: np.ndarray, min_size: int) -> np.ndarray:
    """4-connected components with labels of area < min_size zeroed.

    cv2.connectedComponentsWithStats at connectivity=4 matches ndi.label's
    default cross structure; the stats pass replaces a separate bincount
    (one image scan instead of three, ~2-4x faster on the flusher's hot
    window loop).
    """
    n_lab, comp, stats, _ = cv2.connectedComponentsWithStats(
        mask_u8, connectivity=4, ltype=cv2.CV_32S
    )
    if n_lab > 2 and min_size > 1:
        small = stats[:, cv2.CC_STAT_AREA] < min_size
        small[0] = False
        if small.any():
            comp[small[comp]] = 0
    return comp


def _fill_holes(mask: np.ndarray) -> np.ndarray:
    """ndi.binary_fill_holes equivalent via one border flood fill (uint8 out).

    Background pixels 4-connected to the image border are not holes; every
    other background pixel is. Identical semantics to scipy's default
    structure at a fraction of the cost (the scipy call was the single most
    expensive stage of the flusher's instance-extraction loop).
    """
    h, w = mask.shape
    ff = np.zeros((h + 2, w + 2), np.uint8)
    ff[1:-1, 1:-1] = mask
    flood_mask = np.zeros((h + 4, w + 4), np.uint8)
    cv2.floodFill(ff, flood_mask, (0, 0), 1, flags=4)
    return (mask | (ff[1:-1, 1:-1] == 0)).astype(np.uint8)


def raw_separation_energy(hv_map: np.ndarray) -> np.ndarray:
    """Foreground-independent part of the separation energy (host/cv2 path).

    The HV field points from boundary to centre inside each nucleus, so its
    spatial gradient spikes along the contact line between touching nuclei.
    A wide Sobel (ksize=21) picks that line up; each direction is inverted
    and the two are fused with a max. The same computation can run batched
    on the card (ops/hv_device.py) — this is the dense, expensive
    piece of post-processing.
    """
    grad_h = cv2.Sobel(_unit_range(hv_map[:, :, 0]), cv2.CV_64F, 1, 0, ksize=_SOBEL_KSIZE)
    grad_v = cv2.Sobel(_unit_range(hv_map[:, :, 1]), cv2.CV_64F, 0, 1, ksize=_SOBEL_KSIZE)
    return np.maximum(1.0 - _unit_range(grad_h), 1.0 - _unit_range(grad_v))


def _separation_energy(
    hv_map: np.ndarray, fg: np.ndarray, raw: np.ndarray | None = None
) -> np.ndarray:
    """Energy in [0,1], high where adjacent nuclei should be cut apart;
    background forced to zero. `raw` short-circuits the Sobel stage with a
    precomputed (possibly device-computed) raw energy.

    Computed directly in f32: the result is exactly `fg ? max(raw, 0) : 0`
    — foreground and background never mix arithmetically, so this is
    bit-identical to the earlier f64 round trip at a fraction of the
    memory traffic (the flusher's windows are multi-megapixel)."""
    if raw is None:
        energy = raw_separation_energy(hv_map).astype(np.float32, copy=True)
    elif raw.dtype == np.uint8:  # streaming wire format: e * 255 fixed-point
        energy = raw.astype(np.float32) / 255.0
    else:
        energy = raw.astype(np.float32, copy=True)
    energy[~fg] = 0.0
    np.clip(energy, 0.0, None, out=energy)
    return energy


def _energy_u8(
    hv_map: np.ndarray | None, fg_raw: np.ndarray, raw: np.ndarray | None
) -> np.ndarray:
    """Separation energy as fixed-point u8 (e/255), background zeroed.

    This is the canonical representation of the integer tail: one u8 plane
    instead of three+ f32 passes. A u8 `raw` (the streaming engine's wire
    format) passes through untouched; f32 raw energy / the host Sobel are
    quantised with the SAME round-half-even the device kernels use, so host
    and device agree bit-for-bit. Masking uses the UNFILTERED threshold
    foreground (np >= 0.5) so a device that never sees the host's
    small-component filter computes the identical plane; the size filter
    still governs the watershed mask and the seeds (``segment_instances``).
    """
    if raw is not None and raw.dtype == np.uint8:
        e_u8 = raw.copy()
    else:
        e_f = raw_separation_energy(hv_map) if raw is None else raw
        # np.rint = round-half-even, matching torch.round on the device.
        e_u8 = np.rint(np.clip(e_f, 0.0, 1.0) * 255.0).astype(np.uint8)
    e_u8[~fg_raw] = 0
    return e_u8


def _integer_basin(e_u8: np.ndarray, fg_raw: np.ndarray) -> np.ndarray:
    """Watershed basin from u8 energy, in EXACT integer arithmetic.

    The float recipe is ``-GaussianBlur3x3((1 - e) * fg)`` with the fixed
    [1,2,1]/4 taps cv2 uses at ksize=3. Over u8-quantised energy that equals
    ``-conv([1,2,1]⊗[1,2,1], fg ? 255 - e_u8 : 0) / (255 * 16)`` — and the
    watershed only consumes the ORDERING of basin values, so the division
    can be dropped and the convolution kept in integers (max 16*255 = 4080,
    exact in int16 and in f32). One integer sepFilter2D pass replaces the
    mask/subtract/multiply/blur float pipeline, and a device computing the
    same convolution produces bit-identical values (no float fuzz).
    """
    masked = np.where(fg_raw, 255 - e_u8.astype(np.int16), 0).astype(np.uint8)
    k = np.array([1.0, 2.0, 1.0], np.float32)
    blur = cv2.sepFilter2D(masked, cv2.CV_16S, k, k)  # REFLECT_101, like blur
    return -blur.astype(np.float32)


def _seeds(fg: np.ndarray, boundary: np.ndarray, min_size: int) -> np.ndarray:
    """Int32 marker image: one positive label per nucleus interior."""
    interior = fg & ~boundary
    if not interior.any():
        # Degenerate tile: everything is boundary; fall back to one seed per
        # foreground component so the flood still assigns every fg pixel.
        _, comp = cv2.connectedComponents(
            fg.astype(np.uint8), connectivity=4, ltype=cv2.CV_32S
        )
        return comp
    cleaned = _fill_holes(interior.astype(np.uint8))
    ellipse = cv2.getStructuringElement(
        cv2.MORPH_ELLIPSE, (_SEED_OPEN_KSIZE, _SEED_OPEN_KSIZE)
    )
    cleaned = cv2.morphologyEx(cleaned, cv2.MORPH_OPEN, ellipse)
    return _label_small_filtered(cleaned, int(min_size))


def _use_float_basin() -> bool:
    import os

    return os.getenv("WSINSIGHT_HV_BASIN", "int") in ("f32", "float32", "float")


def segment_instances(
    np_map: np.ndarray,
    hv_map: np.ndarray,
    min_object_size: int,
    raw_energy: np.ndarray | None = None,
) -> np.ndarray:
    """Instance map (H, W) int32 from an NP prob map and HV offset maps.

    Default tail is the exact-integer formulation (u8 energy + integer
    basin, see ``_integer_basin``) shared bit-for-bit with the device
    kernels; ``WSINSIGHT_HV_BASIN=f32`` restores the reference's float
    recipe end-to-end (f32 energy, float Gaussian basin, energy masked by
    the size-FILTERED foreground).
    """
    with _stage("hv.foreground"):
        fg_raw = (
            np_map >= _FG_THRESHOLD
            if np_map.dtype != bool
            else np_map
        )
        if not fg_raw.any():
            return np.zeros(np_map.shape[:2], dtype=np.int32)
        fg = _label_small_filtered(fg_raw.astype(np.uint8), int(min_object_size)) > 0
        if not fg.any():
            return np.zeros(np_map.shape[:2], dtype=np.int32)

    if _use_float_basin():
        with _stage("hv.energy_basin"):
            energy = _separation_energy(hv_map, fg, raw=raw_energy)
            basin = (1.0 - energy) * fg  # deep in nuclei, shallow at contacts
            basin = -cv2.GaussianBlur(basin.astype(np.float32), (3, 3), 0)
            boundary = energy >= _BOUNDARY_THRESHOLD
    else:
        with _stage("hv.energy_basin"):
            e_u8 = _energy_u8(hv_map, fg_raw, raw_energy)
            basin = _integer_basin(e_u8, fg_raw)
            boundary = e_u8 >= _BOUNDARY_U8
    with _stage("hv.seeds"):
        markers = _seeds(fg, boundary, min_object_size)
    with _stage("hv.watershed"):
        return watershed(basin, markers, mask=fg).astype(np.int32)


# Back-compat alias (earlier revisions exported the stage under this name).
proc_np_hv = segment_instances


def _grouped_bboxes(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, boxes) for every positive label, fully vectorised.

    boxes[i] = [cmin, rmin, w, h] for ids[i], computed by sorting the
    foreground pixel indices by label and slicing group extrema — no
    per-instance image scans.
    """
    flat = labels.ravel()
    fg_idx = np.flatnonzero(flat)
    if fg_idx.size == 0:
        return np.empty(0, np.int32), np.empty((0, 4), np.int32)
    labs = flat[fg_idx]
    order = np.argsort(labs, kind="stable")
    labs_sorted = labs[order]
    idx_sorted = fg_idx[order]
    # group boundaries in the sorted pixel stream
    starts = np.flatnonzero(np.r_[True, labs_sorted[1:] != labs_sorted[:-1]])
    ends = np.r_[starts[1:], labs_sorted.size]
    ids = labs_sorted[starts].astype(np.int32)

    w = labels.shape[1]
    rows = (idx_sorted // w).astype(np.int64)
    cols = (idx_sorted % w).astype(np.int64)
    rmin = np.minimum.reduceat(rows, starts)
    rmax = np.maximum.reduceat(rows, starts)
    cmin = np.minimum.reduceat(cols, starts)
    cmax = np.maximum.reduceat(cols, starts)
    # reduceat needs contiguous groups, which the sort guarantees; `ends` is
    # implicit (next start).
    del ends
    boxes = np.stack(
        [cmin, rmin, cmax - cmin + 1, rmax - rmin + 1], axis=1
    ).astype(np.int32)
    return ids, boxes


def _class_means(labels: np.ndarray, tp: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(len(ids), K) mean type-probability per instance via per-class bincount."""
    flat = labels.ravel()
    n_lab = int(ids.max()) + 1
    counts = np.bincount(flat, minlength=n_lab).astype(np.float64)
    counts[counts == 0] = 1.0
    k = tp.shape[2]
    tp_flat = tp.reshape(-1, k)
    sums = np.empty((n_lab, k), dtype=np.float64)
    for c in range(k):
        sums[:, c] = np.bincount(flat, weights=tp_flat[:, c], minlength=n_lab)
    return (sums[ids] / counts[ids, None]).astype(np.float32)


def _instance_polygon(patch: np.ndarray) -> np.ndarray | None:
    """Largest external contour of a binary instance patch, or None."""
    contours, _ = cv2.findContours(patch, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    ring = max(contours, key=cv2.contourArea).squeeze(1).astype(np.int32)
    if ring.ndim != 2 or ring.shape[0] < 3:
        return None
    return ring


def _measure_labels(
    labels: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray | None]]:
    """(labels, ids, boxes, polygons) measurement shared by the streaming
    extraction entry points; polygons[i] is None when degenerate."""
    with _stage("hv.measure_polygons"):
        ids, boxes = _grouped_bboxes(labels)
        polys: List[np.ndarray | None] = []
        for i in range(ids.size):
            x, y, w, h = (int(v) for v in boxes[i])
            patch = (labels[y : y + h, x : x + w] == ids[i]).astype(np.uint8)
            ring = _instance_polygon(patch)
            if ring is not None:
                ring = ring.copy()
                ring[:, 0] += x
                ring[:, 1] += y
            polys.append(ring)
        return labels, ids, boxes, polys


def extract_instance_labels(
    np_tile: np.ndarray,
    raw_energy: np.ndarray,
    interior_slice: tuple[slice, slice],
    min_object_size: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray | None]]:
    """Tile segmentation + measurement WITHOUT class probabilities.

    For a streaming engine (the JAX package's engine/stream_cells.py),
    where per-instance class means are computed on the device from the type
    maps after the label image is known. Returns (labels_interior int32,
    ids, boxes, polygons) with polygons[i] None when degenerate — the caller
    drops those instances everywhere so the alignment guarantee holds.
    """
    labels = segment_instances(np_tile, None, min_object_size, raw_energy)[interior_slice]
    return _measure_labels(labels)


def extract_instance_labels_from_proposal(
    fg_raw: np.ndarray,
    boundary: np.ndarray,
    basin: np.ndarray,
    interior_slice: tuple[slice, slice],
    min_object_size: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray | None]]:
    """Like ``extract_instance_labels``, from a DEVICE-computed proposal.

    The streaming engine's proposal window kernel ships the threshold
    foreground, the boundary mask (e_u8 >= 102) and the negated integer
    basin (see ``_integer_basin``) — all computed on the device in
    exact integer arithmetic, so this path is bit-identical to the host
    tail. What remains here is the intrinsically sequential part:
    connected-component size filtering, seed carving and the watershed.
    """
    with _stage("hv.foreground"):
        if not fg_raw.any():
            z = np.zeros(fg_raw.shape, np.int32)[interior_slice]
            return z, np.empty(0, np.int32), np.empty((0, 4), np.int32), []
        fg = _label_small_filtered(fg_raw.astype(np.uint8), int(min_object_size)) > 0
        if not fg.any():
            z = np.zeros(fg_raw.shape, np.int32)[interior_slice]
            return z, np.empty(0, np.int32), np.empty((0, 4), np.int32), []
    with _stage("hv.seeds"):
        markers = _seeds(fg, boundary, min_object_size)
    with _stage("hv.watershed"):
        labels = watershed(basin, markers, mask=fg).astype(np.int32)[interior_slice]
    return _measure_labels(labels)


def extract_instances(
    np_tile: np.ndarray,
    hv_tile: np.ndarray,
    tp_tile: np.ndarray,
    interior_y0: int,
    interior_x0: int,
    interior_slice: tuple[slice, slice],
    min_object_size: int,
    raw_energy: np.ndarray | None = None,
) -> tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Segment one padded tile and measure the instances in its interior.

    Returns aligned lists of (1,4) bbox rows [x,y,w,h], (1,K) class-prob
    rows, and (M,2) contour polygons — all in global slide coordinates.
    len(bboxes) == len(probs) == len(polygons) always holds (see module
    docstring). `raw_energy` optionally supplies the device-computed Sobel
    stage for this tile.
    """
    ys, xs = interior_slice
    labels = segment_instances(np_tile, hv_tile, min_object_size, raw_energy)[ys, xs]
    ids, boxes = _grouped_bboxes(labels)
    if ids.size == 0:
        return [], [], []
    probs = _class_means(labels, tp_tile[ys, xs, :].astype(np.float64), ids)

    inst_list: List[np.ndarray] = []
    prob_list: List[np.ndarray] = []
    poly_list: List[np.ndarray] = []
    for i in range(ids.size):
        x, y, w, h = (int(v) for v in boxes[i])
        patch = (labels[y : y + h, x : x + w] == ids[i]).astype(np.uint8)
        ring = _instance_polygon(patch)
        if ring is None:
            continue  # keep the three lists aligned (see module docstring)
        ring[:, 0] += x + interior_x0
        ring[:, 1] += y + interior_y0
        inst_list.append(
            np.array([x + interior_x0, y + interior_y0, w, h], np.int32).reshape(1, -1)
        )
        prob_list.append(probs[i].reshape(1, -1))
        poly_list.append(ring)
    return inst_list, prob_list, poly_list
