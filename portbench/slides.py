"""Seeded synthetic slides, written once per checkout under ``.cache/`` and
keyed by their parameters, and what set-up derives from a slide alone (its
decoded patches), cached beside it. The writers are copies of
``chip_smoke.py``'s (j) and (l) slides: H&E tones on neutral glass with
per-pixel noise, as a 3-level JPEG pyramid with tiles of 256, and for the
cell path dark-purple nuclei 4-8 um across drawn over the tissue. A traffic
file's ``slide`` object gives the parameters; its ``seed`` is the slide's
own, so every run of a cell reads the same slide."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .common import CACHE_DIR

BACKGROUND = (236, 236, 236)  # neutral glass: no saturation
# H&E tones: hematoxylin-rich purples, eosin pinks
TONES = ((176, 98, 168), (214, 132, 186), (150, 80, 160), (226, 160, 200))
NUCLEUS_TONE = (96, 52, 132)


def tissue_blobs(side: int, tissue: float, rng: np.random.Generator) -> tuple[list, float]:
    """Seeded tissue ellipses in H&E tones, added until they cover ``tissue``
    of a coarse grid: ([(y, x, ry, rx, tone)], share covered)."""
    coarse = np.linspace(0, side, 256, endpoint=False)
    cy, cx = np.meshgrid(coarse, coarse, indexing="ij")
    covered = np.zeros(cy.shape, bool)
    blobs = []
    while covered.mean() < tissue:
        y, x = rng.uniform(0.15, 0.85, 2) * side
        ry, rx = rng.uniform(0.08, 0.2, 2) * side
        blobs.append((y, x, ry, rx, TONES[len(blobs) % len(TONES)]))
        covered |= ((cy - y) / ry) ** 2 + ((cx - x) / rx) ** 2 <= 1
    return blobs, float(covered.mean())


def _paint(side: int, blobs: list) -> np.ndarray:
    img = np.empty((side, side, 3), np.uint8)
    xs = np.arange(side, dtype=np.float32)[None, :]
    for y0 in range(0, side, 512):
        ys = np.arange(y0, min(side, y0 + 512), dtype=np.float32)[:, None]
        img[y0:y0 + len(ys)] = BACKGROUND
        for y, x, ry, rx, tone in blobs:
            img[y0:y0 + len(ys)][((ys - y) / ry) ** 2 + ((xs - x) / rx) ** 2 <= 1] = tone
    return img


def _noise(img: np.ndarray, amplitude: int, rng: np.random.Generator) -> None:
    for y0 in range(0, img.shape[0], 512):
        strip = img[y0:y0 + 512].astype(np.int16)
        strip += rng.integers(-amplitude, amplitude + 1, strip.shape, dtype=np.int16)
        img[y0:y0 + 512] = np.clip(strip, 0, 255)


def draw_nuclei(img: np.ndarray, per_px2: float, radii: tuple[int, int],
                rng: np.random.Generator) -> tuple:
    """Dark-purple ellipses over the tissue, one per 1/per_px2 px^2 of slide:
    (centres (n, 2) x, y; radii (n, 2); angles (n,)) of those drawn."""
    import cv2

    side = img.shape[0]
    n = int(side * side * per_px2)
    centres = rng.integers(0, side, (n, 2))
    rad = rng.integers(radii[0], radii[1], (n, 2), endpoint=True)
    angles = rng.uniform(0, 180, n)
    keep = (img[centres[:, 1], centres[:, 0]] != BACKGROUND).any(axis=1)
    for (x, y), (rx, ry), a in zip(centres[keep], rad[keep], angles[keep]):
        cv2.ellipse(img, (int(x), int(y)), (int(rx), int(ry)), float(a), 0, 360, NUCLEUS_TONE, -1)
    return centres[keep], rad[keep], angles[keep]


def nuclei_mask(side: int, nuclei) -> np.ndarray:
    """(side, side) uint8: 1 inside a drawn nucleus."""
    import cv2

    mask = np.zeros((side, side), np.uint8)
    for (x, y), (rx, ry), a in zip(*nuclei):
        cv2.ellipse(mask, (int(x), int(y)), (int(rx), int(ry)), float(a), 0, 360, 1, -1)
    return mask


def _key(params: dict) -> str:
    return hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]


def cached(prefix: str, params: dict, make) -> dict:
    """The arrays that ``make()`` returns for ``params``, written on first use
    under ``.cache/<prefix>-<key>/`` (one ``.npy`` each) and read back
    memory-mapped on later runs: set-up inputs that the seed does not
    change, such as a slide's decoded patches."""
    import shutil

    out = CACHE_DIR / f"{prefix}-{_key(params)}"
    if not out.is_dir():
        arrays = make()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        tmp.mkdir(parents=True)
        for name, value in arrays.items():
            np.save(tmp / f"{name}.npy", value)
        try:
            os.replace(tmp, out)
        except OSError:  # another process wrote it first
            shutil.rmtree(tmp)
    return {p.stem: np.load(p, mmap_mode="r") for p in out.glob("*.npy")}


def slide(params: dict) -> tuple[str, tuple | None]:
    """The slide of ``params`` (side, mpp, tissue, noise, seed, and for the
    cell path nuclei_per_px2 and nucleus_radii), written on first use:
    (path, the drawn nuclei or None)."""
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    key = _key(params)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    path = CACHE_DIR / f"slide-{key}.tif"
    nuclei_path = CACHE_DIR / f"slide-{key}.nuclei.npz"
    with_nuclei = "nuclei_per_px2" in params
    if not path.exists():
        rng = np.random.default_rng(params["seed"])
        side = params["side"]
        blobs, _ = tissue_blobs(side, params["tissue"], rng)
        img = _paint(side, blobs)
        if with_nuclei:
            nuclei = draw_nuclei(img, params["nuclei_per_px2"], tuple(params["nucleus_radii"]),
                                 rng)
            tmp = nuclei_path.with_name(f"{nuclei_path.name}.{os.getpid()}.tmp.npz")
            np.savez(tmp, centres=nuclei[0], radii=nuclei[1], angles=nuclei[2])
            os.replace(tmp, nuclei_path)
        _noise(img, params["noise"], rng)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        write_pyramidal_tiff(tmp, img, tile=(256, 256), compression="jpeg", mpp=params["mpp"],
                             levels=3)
        os.replace(tmp, path)
    if not with_nuclei:
        return str(path), None
    with np.load(nuclei_path) as z:
        return str(path), (z["centres"], z["radii"], z["angles"])
