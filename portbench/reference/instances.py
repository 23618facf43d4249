"""Nuclei instances as the configuration's post-processing defines them for a
zero HV field (the benchmark zeroes the HV head, so every foreground
component is one nucleus): foreground where the nuclei probability is at
least 0.5, 4-connected components, those under ``min_size`` pixels dropped,
and those whose largest outer contour has fewer than 3 points (no polygon)
dropped; per instance its box [x, y, w, h] and the mean type probability
over its pixels. Then the matching of two instance sets by their boxes."""

from __future__ import annotations

import cv2
import numpy as np
from scipy import ndimage


def _stable_labels(labels: np.ndarray, np_prob: np.ndarray, margin: float,
                   min_size: int) -> np.ndarray:
    """Per label of ``labels`` (the components at p >= 0.5), whether it is
    the same nucleus for a nuclei logit moved by up to ``margin`` either way:
    one component, of at least ``min_size`` pixels, at the higher cut, and
    no other component joining it at the lower cut. A nucleus that a
    rounding error of the logit can split, merge, or take under the size
    cut is not one whose presence says anything about the program."""
    lo, hi = 1.0 / (1.0 + np.exp(margin)), 1.0 / (1.0 + np.exp(-margin))
    n = int(labels.max())
    lab_hi, _ = ndimage.label(np_prob >= hi)
    lab_lo, _ = ndimage.label(np_prob >= lo)
    ok = np.ones(n + 1, bool)
    both = (labels > 0) & (lab_hi > 0)
    pairs = np.unique(np.stack([labels[both], lab_hi[both]]), axis=1)
    per_main = np.bincount(pairs[0], minlength=n + 1)
    ok &= per_main == 1
    hi_size = np.bincount(lab_hi.ravel())
    small = hi_size[pairs[1]] < min_size
    ok[pairs[0][small]] = False
    fg = labels > 0
    pairs = np.unique(np.stack([lab_lo[fg], labels[fg]]), axis=1)
    joined = np.bincount(pairs[0], minlength=int(lab_lo.max()) + 1) > 1
    ok[pairs[1][joined[pairs[0]]]] = False
    return ok


def _has_polygon(mask: np.ndarray) -> bool:
    contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return bool(contours) and len(max(contours, key=cv2.contourArea)) >= 3


def instances(np_prob: np.ndarray, tp_prob: np.ndarray, origin: tuple[int, int],
              min_size: int = 20, margin: float = 0.25) -> dict:
    """The instances of an (H, W) nuclei-probability map and its (K, H, W)
    type map whose top-left pixel is at slide ``origin`` (x, y): ``boxes``
    (n, 4) in slide pixels, ``probs`` (n, K) mean type probabilities,
    ``stable`` (n,) whether each is the same nucleus under a nuclei-logit
    change of ``margin``, and ``near`` (H, W), the foreground at the lower
    cut, where a rounding of the logit can make an instance."""
    lo = 1.0 / (1.0 + np.exp(margin))
    out = {"boxes": np.zeros((0, 4), np.int64), "probs": np.zeros((0, tp_prob.shape[0])),
           "stable": np.zeros(0, bool), "near": np_prob >= lo, "origin": origin}
    labels, n = ndimage.label(np_prob >= 0.5)
    if n == 0:
        return out
    stable = _stable_labels(labels, np_prob, margin, min_size)
    sizes = np.bincount(labels.ravel(), minlength=n + 1)
    k = tp_prob.shape[0]
    sums = np.stack([np.bincount(labels.ravel(), weights=tp_prob[c].ravel(), minlength=n + 1)
                     for c in range(k)], axis=1)
    boxes, probs, flags = [], [], []
    for lab, sl in enumerate(ndimage.find_objects(labels), start=1):
        if sl is None or sizes[lab] < min_size:
            continue
        if not _has_polygon((labels[sl] == lab).astype(np.uint8)):
            continue
        y, x = sl[0].start, sl[1].start
        boxes.append((x + origin[0], y + origin[1], sl[1].stop - x, sl[0].stop - y))
        probs.append(sums[lab] / sizes[lab])
        flags.append(stable[lab])
    out.update(boxes=np.array(boxes, np.int64).reshape(-1, 4),
               probs=np.array(probs).reshape(-1, k), stable=np.array(flags, bool))
    return out


def inside(boxes: np.ndarray, area: tuple[int, int, int, int], tile: int) -> np.ndarray:
    """Mask of the boxes strictly inside ``area`` (x, y, w, h) that neither
    touch nor cross a line of the engine's watershed tiles (every ``tile``
    px from 0): the post-processing cuts instances there, so only those
    away from the lines are whole on both sides."""
    x, y, w, h = (boxes[:, i] for i in range(4))
    ax, ay, aw, ah = area
    ok = (x > ax) & (y > ay) & (x + w < ax + aw) & (y + h < ay + ah)
    for lo, size in ((x, w), (y, h)):
        ok &= (lo % tile != 0) & ((lo + size) % tile != 0) & (lo // tile == (lo + size - 1) // tile)
    return ok


def match(a: np.ndarray, b: np.ndarray, min_iou: float = 0.5) -> list[tuple[int, int]]:
    """Pairs (i, j) of boxes of ``a`` and ``b`` matched one to one, greedily
    by the highest box IoU, down to ``min_iou``."""
    if not len(a) or not len(b):
        return []
    ax0, ay0, ax1, ay1 = a[:, 0, None], a[:, 1, None], (a[:, 0] + a[:, 2])[:, None], \
        (a[:, 1] + a[:, 3])[:, None]
    bx0, by0, bx1, by1 = b[None, :, 0], b[None, :, 1], (b[:, 0] + b[:, 2])[None], \
        (b[:, 1] + b[:, 3])[None]
    iw = np.clip(np.minimum(ax1, bx1) - np.maximum(ax0, bx0), 0, None)
    ih = np.clip(np.minimum(ay1, by1) - np.maximum(ay0, by0), 0, None)
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    iou = inter / np.maximum(union, 1)
    pairs, used_a, used_b = [], set(), set()
    for flat in np.argsort(-iou, axis=None):
        i, j = divmod(int(flat), iou.shape[1])
        if iou[i, j] < min_iou:
            break
        if i not in used_a and j not in used_b:
            pairs.append((i, j))
            used_a.add(i)
            used_b.add(j)
    return pairs


def compare(prog_boxes, prog_probs, ref: dict, area, tile) -> dict:
    """The instance numbers of one region against the reference's
    ``instances``. ``inst_mean_gap``: over the reference's stable nuclei and
    the program's instances where the reference has no foreground even at
    the lower cut, the mean of the widest type-probability gap of each
    nucleus to its match, where a stable nucleus left unmatched, or an
    instance of the program's own, counts 1. Reported beside it: the share
    of all instances left unmatched and the widest gap of a matched pair."""
    pm, rm = inside(prog_boxes, area, tile), inside(ref["boxes"], area, tile)
    pb, pp = prog_boxes[pm], prog_probs[pm]
    rb, rp, rs = ref["boxes"][rm], ref["probs"][rm], ref["stable"][rm]
    pairs = match(pb, rb)
    to_prog = {j: i for i, j in pairs}
    gaps = [float(np.abs(pp[to_prog[j]] - rp[j]).max()) if j in to_prog else 1.0
            for j in np.flatnonzero(rs)]
    matched = {i for i, _ in pairs}
    ox, oy = ref["origin"]
    for i, (x, y, w, h) in enumerate(pb):
        if i not in matched and not ref["near"][y - oy:y - oy + h, x - ox:x - ox + w].any():
            gaps.append(1.0)
    total = len(pb) + len(rb)
    return {"instances_ref": len(rb), "instances_prog": len(pb),
            "instances_unstable": int((~rs).sum()),
            "inst_unmatched_pct": 100.0 * (total - 2 * len(pairs)) / max(1, total),
            "inst_prob_gap": max((float(np.abs(pp[i] - rp[j]).max()) for i, j in pairs),
                                 default=0.0),
            "inst_mean_gap": float(np.mean(gaps)) if gaps else 1.0}
