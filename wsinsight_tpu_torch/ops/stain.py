"""Macenko stain estimation and deconvolution-based normalization in torch.

Counterpart of wsinsight_tpu/ops/stain.py, which replaces histomicstk's
Cython path (reference: wsinsight/modellib/run_inference.py:232-266 for
estimation on one shuffled 256-patch batch; modellib/data.py:292-300 for
per-patch normalization):

* RGB -> SDA optical density (htk rgb_to_sda convention with I_0),
* Macenko PCA: top-2 OD eigenvectors, robust angle percentiles, stain vectors,
* concentrations by least squares against the stain matrix,
* re-composition with a target stain matrix (eosin/hematoxylin/null).

The tensors stay on the caller's device. One step does not: the 3x3
eigendecomposition of the optical-density covariance runs on the host's
LAPACK, whatever the device. An eigenvector's sign is the solver's choice,
and the angle percentiles depend on it (the second eigenvector's sign can
move every angle across the +-pi cut), so cuSOLVER on the card could give
another stain matrix than LAPACK on the CPU; the host's LAPACK gives the
signs the JAX package's CPU ``eigh`` gives.

Default target stains match the reference's stain_color_map selection
(run_inference.py:262-264).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

EPSILON = 1e-8
I_0 = 255.0

# histomicstk stain_color_map entries used by the reference.
STAIN_COLOR_MAP = {
    "hematoxylin": (0.65, 0.70, 0.29),
    "eosin": (0.07, 0.99, 0.11),
    "dab": (0.27, 0.57, 0.78),
    "null": (0.0, 0.0, 0.0),
}


def default_target_stains() -> np.ndarray:
    """W_def: columns eosin, hematoxylin, null (reference order)."""
    stains = ["eosin", "hematoxylin", "null"]
    w = np.array([STAIN_COLOR_MAP[s] for s in stains], dtype=np.float32).T
    return complement_stain_matrix(w)


def complement_stain_matrix(w: np.ndarray) -> np.ndarray:
    """Fill zero columns with the unit-normalized cross product of the others."""
    w = np.array(w, dtype=np.float32)
    for i in range(3):
        if np.allclose(w[:, i], 0):
            a = w[:, (i + 1) % 3]
            b = w[:, (i + 2) % 3]
            c = np.cross(a, b)
            n = np.linalg.norm(c)
            w[:, i] = c / n if n > 0 else c
    # normalize columns
    norms = np.linalg.norm(w, axis=0)
    norms[norms == 0] = 1.0
    return (w / norms).astype(np.float32)


def rgb_to_sda(im: torch.Tensor, i_0: float = I_0) -> torch.Tensor:
    """htk rgb_to_sda: -log(im / I_0) * 255 / log(I_0)."""
    im = torch.clamp(im, min=EPSILON)
    return -torch.log(im / i_0) * (255.0 / np.log(i_0))


def sda_to_rgb(sda: torch.Tensor, i_0: float = I_0) -> torch.Tensor:
    return i_0 * torch.exp(-sda * (np.log(i_0) / 255.0))


def _top2_eigenvectors(cov: torch.Tensor) -> torch.Tensor:
    """(3, 2) eigenvectors of the two largest eigenvalues of a symmetric
    (3, 3) float32 matrix, ascending, from the host's LAPACK (see the module
    docstring), on ``cov``'s device."""
    _, evecs = torch.linalg.eigh(cov.detach().to("cpu", torch.float32))
    return evecs[:, -2:].to(cov.device)


def macenko_stain_matrix(
    pixels_rgb: torch.Tensor,
    i_0: float = I_0,
    minimum_magnitude: float = 16.0,
    min_angle_percentile: float = 0.01,
    max_angle_percentile: float = 0.99,
) -> torch.Tensor:
    """Estimate the (3,3) stain matrix from (N,3) RGB pixels (Macenko PCA).

    Magnitude filtering is done with weights instead of boolean indexing, and
    the angle percentiles are order statistics of a masked sort at an integer
    index (no interpolation), as in the JAX function.
    """
    sda = rgb_to_sda(pixels_rgb.to(torch.float32), i_0)  # (N, 3)
    mag = torch.linalg.vector_norm(sda, dim=1)
    w = (mag > minimum_magnitude).to(torch.float32)

    # Mean and covariance accumulate in float64: float32 sums over a 1 M
    # pixel sample drift with their order (up to 7e-4 relative in the JAX
    # package's), and where the second and third eigenvalues are close the
    # second eigenvector follows that drift; in float64 the card and the
    # CPU agree.
    s64, w64 = sda.to(torch.float64), w.to(torch.float64)
    wsum = torch.clamp(w64.sum(), min=1.0)
    mean = (s64 * w64[:, None]).sum(0) / wsum
    centered = (s64 - mean) * w64[:, None]
    cov = (centered.T @ centered / wsum).to(torch.float32)
    basis = _top2_eigenvectors(cov)  # top-2 eigenvectors (columns)

    proj = sda @ basis  # (N, 2)
    angles = torch.atan2(proj[:, 1], proj[:, 0])
    # Weighted percentile via masked sort: push filtered-out pixels to +inf.
    angles_masked = torch.where(w > 0, angles, torch.full_like(angles, float("inf")))
    order = torch.sort(angles_masked).values
    n_valid = int(w.sum().item())
    last = len(angles) - 1
    lo_idx = min(max(int(np.float32(min_angle_percentile) * np.float32(n_valid)), 0), last)
    hi_idx = min(max(int(np.float32(max_angle_percentile) * np.float32(n_valid)), 0), last)
    a_min = order[lo_idx]
    a_max = order[hi_idx]

    def angle_to_vector(a):
        d = torch.stack([torch.cos(a), torch.sin(a)])
        v = basis @ d
        return v / torch.clamp(torch.linalg.vector_norm(v), min=EPSILON)

    v1 = angle_to_vector(a_min)
    v2 = angle_to_vector(a_max)
    # Column order here is by projection extreme, not by stain identity;
    # estimate_stains_from_batch reorders the columns by colour similarity.
    s3 = torch.linalg.cross(v1, v2)
    s3 = s3 / torch.clamp(torch.linalg.vector_norm(s3), min=EPSILON)
    return torch.stack([v1, v2, s3], dim=1)  # columns = stains


def color_deconvolution(im_rgb: torch.Tensor, w: torch.Tensor, i_0: float = I_0) -> torch.Tensor:
    """Stain concentrations: solve sda = W @ c per pixel. im (..., 3)."""
    sda = rgb_to_sda(im_rgb, i_0)
    w_inv = torch.linalg.inv(w)
    return torch.einsum("ij,...j->...i", w_inv, sda)


def color_convolution(conc: torch.Tensor, w: torch.Tensor, i_0: float = I_0) -> torch.Tensor:
    sda = torch.einsum("ij,...j->...i", w, conc)
    return torch.clamp(sda_to_rgb(sda, i_0), 0.0, 255.0)


def deconvolution_based_normalization(
    im_rgb: torch.Tensor,
    w_source: torch.Tensor,
    w_target: torch.Tensor,
    i_0: float = I_0,
) -> torch.Tensor:
    """Map image stains from w_source space to w_target space (htk
    equivalent, reference: modellib/data.py:295-299). float32 (..., 3)."""
    conc = color_deconvolution(im_rgb, w_source, i_0)
    return color_convolution(conc, w_target, i_0)


def _match_stain_order(w: np.ndarray) -> np.ndarray:
    """Reorder the two estimated stain columns to (eosin, hematoxylin).

    Concentrations are re-rendered positionally against the target matrix
    (columns eosin, hematoxylin, null, the reference's order,
    run_inference.py:263-264), so the source columns must carry the same
    identities: pick the pairing whose columns are most cosine-similar to the
    canonical stain colors, else every normalized patch swaps H and E.
    """
    w = np.array(w, dtype=np.float32)

    def unit(v):
        v = np.asarray(v, np.float32)
        return v / max(float(np.linalg.norm(v)), EPSILON)

    e_ref = unit(STAIN_COLOR_MAP["eosin"])
    h_ref = unit(STAIN_COLOR_MAP["hematoxylin"])
    c0, c1 = unit(w[:, 0]), unit(w[:, 1])
    keep = float(c0 @ e_ref + c1 @ h_ref)
    swapped = float(c1 @ e_ref + c0 @ h_ref)
    if swapped > keep:
        w = w[:, [1, 0, 2]]
    # re-derive the residual column for the (possibly) new ordering
    w[:, 2] = np.cross(w[:, 0], w[:, 1])
    return w


def estimate_stains_from_batch(
    batch_u8: np.ndarray, max_pixels: int = 1 << 20, device: str | torch.device = "cpu"
) -> np.ndarray:
    """W_est, (3, 3) float32, from a (B,H,W,3) uint8 sample batch (the
    reference samples one shuffled 256-patch batch, run_inference.py:259-261),
    with the Macenko PCA on ``device``.

    Degenerate samples (blank background, saturated white, single-color
    tissue) make the Macenko PCA rank-deficient or non-finite; those fall
    back to the default target stains, turning normalization into a no-op
    instead of poisoning every downstream patch.
    """
    pixels = np.asarray(batch_u8, dtype=np.float32).reshape(-1, 3) + EPSILON
    if len(pixels) > max_pixels:
        idx = np.random.default_rng(0).choice(len(pixels), max_pixels, replace=False)
        pixels = pixels[idx]
    w = macenko_stain_matrix(torch.from_numpy(pixels).to(device))
    w = _match_stain_order(w.cpu().numpy())
    w = complement_stain_matrix(w)
    if not np.isfinite(w).all() or abs(float(np.linalg.det(w))) < 1e-6:
        logger.warning(
            "stain estimation sample is degenerate (blank/single-color batch);"
            " using default target stains"
        )
        return default_target_stains()
    return w
