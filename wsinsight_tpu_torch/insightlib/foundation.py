"""Foundation-model cell embeddings for CME graphs (H-Optimus branch).

Counterpart of wsinsight_tpu/insightlib/foundation.py, a re-creation of the
reference's optional H-Optimus-0 feature block
(reference: wsinsight/insightlib/cme_generation.py:420-490,753-782): embed a
sampled subset of cells with a large pretrained vision encoder, reduce with
PCA, and impute features for every remaining cell by Gaussian-weighted
k-nearest-neighbour interpolation in micron space.

The encoder is pluggable: anything callable as ``(images_u8 [B,H,W,3]) ->
[B,D] float32`` works, so tests run with a cheap deterministic stub and
production runs H-Optimus-0 on the card (``vit_hoptimus_extractor``: the
port's ``FoundationViT``, attention by K2) from converted weights, or the
timm checkpoint (``hoptimus_extractor``) where those are not on disk. Cell crops come from a ``SlideCropSource`` that
reads real 224-px windows around cell centres from the WSI — the reference's
default dataset returned blank images (cme_generation.py:420-433), which
made the branch decorative; crops make it functional.
"""

from __future__ import annotations

from typing import Callable, Protocol, Sequence

import numpy as np
import torch

FeatureExtractor = Callable[[np.ndarray], np.ndarray]


class CellPatchSource(Protocol):
    """Supplies an RGB uint8 crop for one cell id."""

    def __len__(self) -> int: ...

    def __getitem__(self, cell_id: int) -> np.ndarray: ...


class BlankPatchSource:
    """All-black crops — the reference's placeholder dataset."""

    def __init__(self, num_cells: int, size: int = 224):
        self.num_cells = int(num_cells)
        self.size = int(size)

    def __len__(self) -> int:
        return self.num_cells

    def __getitem__(self, cell_id: int) -> np.ndarray:
        return np.zeros((self.size, self.size, 3), np.uint8)


class SlideCropSource:
    """224-px crops around cell centres, read from the slide on demand."""

    def __init__(self, slide, centers_xy_px: np.ndarray, size: int = 224):
        self.slide = slide
        self.centers = np.asarray(centers_xy_px, np.int64)
        self.size = int(size)

    def __len__(self) -> int:
        return len(self.centers)

    def __getitem__(self, cell_id: int) -> np.ndarray:
        cx, cy = (int(v) for v in self.centers[cell_id])
        half = self.size // 2
        region = self.slide.read_region(
            (cx - half, cy - half), 0, (self.size, self.size)
        )
        arr = np.asarray(region)[:, :, :3]
        return np.ascontiguousarray(arr, np.uint8)


def stub_extractor(dim: int = 48) -> FeatureExtractor:
    """Deterministic, cheap extractor for tests: random-projected image stats."""

    def extract(images_u8: np.ndarray) -> np.ndarray:
        x = np.asarray(images_u8, np.float32) / 255.0
        b = x.shape[0]
        # channel means/stds over a 4x4 spatial grid -> 96 raw stats
        h, w = x.shape[1], x.shape[2]
        gh, gw = max(1, h // 4), max(1, w // 4)
        cells = x[:, : gh * 4, : gw * 4, :].reshape(b, 4, gh, 4, gw, 3)
        mu = cells.mean(axis=(2, 4)).reshape(b, -1)
        sd = cells.std(axis=(2, 4)).reshape(b, -1)
        raw = np.concatenate([mu, sd], axis=1)
        proj = np.random.default_rng(0).standard_normal((raw.shape[1], dim)).astype(np.float32)
        return (raw @ proj).astype(np.float32)

    return extract


# H-Optimus-0's published normalization constants (HF model card /
# timm data config; the reference applies them via timm's create_transform,
# cme_generation.py:449-452).
HOPTIMUS_MEAN = (0.707223, 0.578729, 0.703617)
HOPTIMUS_STD = (0.211883, 0.230117, 0.177517)


def vit_hoptimus_extractor(
    params: dict | None = None,
    batch_size: int = 64,
    mixed_precision: bool = True,
    device=None,
    state_dict: dict | None = None,
) -> FeatureExtractor:
    """H-Optimus-0 embeddings on the card: the port's ``FoundationViT``
    (ViT-g/14, reg4 DINOv2 layout, ``models/vit.py``) with K2 as every
    block's attention. Counterpart of the JAX package's
    ``flax_hoptimus_extractor``.

    Weights: ``state_dict`` (the port model's), else ``params`` (a flax tree
    of arrays, carried across), else ``$WSINSIGHT_MODEL_DIR/hoptimus0.msgpack``
    (the JAX package's converted checkpoint, read without flax);
    ``WeightsNotFoundError`` where none is given or found. bfloat16 autocast
    under ``mixed_precision``, else float32 with TF32 off. Crops other than
    224 px are resized with ``jax.image.resize``'s antialiased bicubic
    kernel; ragged batches are padded to ``batch_size``, as in the JAX one.
    """
    from ..engine.runner import tf32_flags
    from ..models import vit
    from ..models.convert import flax_params_to_state_dict, load_flax_msgpack
    from ..ops.resize import resize_axis
    from ..parallel.mesh import resolve_device

    dev = resolve_device(device)
    dtype = torch.bfloat16 if mixed_precision else torch.float32
    if state_dict is None and params is None:
        import os
        from pathlib import Path

        from ..zoo import WeightsNotFoundError

        model_dir = os.getenv("WSINSIGHT_MODEL_DIR")
        cand = Path(model_dir) / "hoptimus0.msgpack" if model_dir else None
        if cand is None or not cand.exists():
            raise WeightsNotFoundError(
                "H-Optimus-0 weights not found; convert the timm checkpoint with"
                " scripts/convert_torch_to_flax.py --arch hoptimus and place it at"
                " $WSINSIGHT_MODEL_DIR/hoptimus0.msgpack"
            )
        params = load_flax_msgpack(cand)
    model = vit.FoundationViT(vit.HOPTIMUS_VIT_G, img_size=224, dtype=dtype)
    if state_dict is None:
        state_dict = flax_params_to_state_dict(params, model)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(dev).eval()
    mean = torch.tensor(HOPTIMUS_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(HOPTIMUS_STD, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fwd(images_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(images_u8).to(dev).float() / 255.0
        if x.shape[1:3] != (224, 224):
            x = resize_axis(resize_axis(x, 1, 224, "cubic"), 2, 224, "cubic")
        with tf32_flags(False):
            return model((x - mean) / std).cpu().numpy()

    def extract(images_u8: np.ndarray) -> np.ndarray:
        feats = []
        n = len(images_u8)
        for i0 in range(0, n, batch_size):
            chunk = np.asarray(images_u8[i0 : i0 + batch_size], np.uint8)
            valid = len(chunk)
            if valid < batch_size:  # pad to the batch shape
                pad = np.zeros((batch_size - valid, *chunk.shape[1:]), np.uint8)
                chunk = np.concatenate([chunk, pad])
            feats.append(fwd(chunk)[:valid])
        return np.concatenate(feats, axis=0).astype(np.float32)

    return extract


def default_foundation_extractor(batch_size: int = 128) -> FeatureExtractor:
    """The port's H-Optimus on the card when converted weights are on disk;
    the timm/torch path only where they are not (``WeightsNotFoundError``).
    Any other failure of the port's ViT or of K2 raises."""
    from ..zoo import WeightsNotFoundError

    try:
        return vit_hoptimus_extractor(batch_size=min(batch_size, 64))
    except WeightsNotFoundError:
        return hoptimus_extractor(batch_size=batch_size)


def hoptimus_extractor(batch_size: int = 128, device: str | None = None) -> FeatureExtractor:
    """H-Optimus-0 encoder via timm (reference: cme_generation.py:435-475).

    Requires the timm package and the bioptimus/H-optimus-0 checkpoint
    (locally cached or reachable); raises ImportError/OSError otherwise so
    callers can surface a clear message. Runs on the card unless ``device``
    names the CPU (or ``WSINFER_FORCE_CPU`` is set).
    """
    import timm  # noqa: F401  (gated import; not bundled in all environments)
    from timm.data import create_transform, resolve_data_config

    from ..parallel.mesh import resolve_device

    dev = resolve_device(device)
    model = (
        timm.create_model("hf-hub:bioptimus/H-optimus-0", pretrained=True, num_classes=0)
        .to(dev)
        .eval()
    )
    # pretrained_cfg carries hub metadata (url, hf_hub_id, ...) that
    # create_transform does not accept; resolve_data_config filters it down
    # to the input/normalisation keys the transform factory understands.
    data_cfg = resolve_data_config(model=model)
    pre = create_transform(**data_cfg, is_training=False)

    def extract(images_u8: np.ndarray) -> np.ndarray:
        from PIL import Image

        feats = []
        with torch.no_grad():
            for i0 in range(0, len(images_u8), batch_size):
                ims = [Image.fromarray(im) for im in images_u8[i0 : i0 + batch_size]]
                x = torch.stack([pre(im) for im in ims]).to(dev)
                feats.append(model(x).detach().cpu().numpy())
        return np.concatenate(feats, axis=0).astype(np.float32)

    return extract


def embed_sampled_cells(
    source: CellPatchSource,
    sampled_ids: Sequence[int],
    extractor: FeatureExtractor,
    batch_size: int = 128,
) -> np.ndarray:
    """Extract features for the sampled cell ids, batched. Returns [m, D]."""
    feats = []
    ids = list(sampled_ids)
    for i0 in range(0, len(ids), batch_size):
        chunk = np.stack([np.asarray(source[i]) for i in ids[i0 : i0 + batch_size]])
        feats.append(np.asarray(extractor(chunk), np.float32))
    return np.concatenate(feats, axis=0)


def pca_reduce(feats: np.ndarray, dim: int) -> np.ndarray:
    """PCA to `dim` components (no-op when feats are already narrower)."""
    dim = min(int(dim), feats.shape[0])  # PCA needs n_components <= n_samples
    if dim <= 0 or feats.shape[1] <= dim:
        return feats.astype(np.float32)
    from .stats import pca_fit_transform

    return pca_fit_transform(feats, dim).astype(np.float32)


def gaussian_knn_impute(
    coords_um: np.ndarray,
    sampled_idx: np.ndarray,
    sampled_feats: np.ndarray,
    k: int = 3,
    sigma_um: float = 60.0,
) -> np.ndarray:
    """Impute features for every cell from its k nearest sampled cells.

    Weights are Gaussian in micron distance, w = exp(-(d/sigma)^2) (+eps),
    normalised per row — exactly the reference's imputation math
    (cme_generation.py:477-490).
    """
    from scipy.spatial import cKDTree

    tree = cKDTree(coords_um[sampled_idx])
    d, nn = tree.query(coords_um, k=min(k, len(sampled_idx)))
    if np.ndim(nn) == 1:
        d = d[:, None]
        nn = nn[:, None]
    eps = 1e-8
    w = np.exp(-((d / max(sigma_um, eps)) ** 2)).astype(np.float32) + eps
    w /= w.sum(axis=1, keepdims=True)
    neighbors = sampled_feats[nn]  # [N, k, D]
    return (w[..., None] * neighbors).sum(axis=1).astype(np.float32)


def foundation_feature_block(
    coords_um: np.ndarray,
    kept_idx: np.ndarray,
    patch_source: CellPatchSource | None,
    extractor: FeatureExtractor | None,
    *,
    sample_frac: float | None = 0.2,
    sample_count: int | None = None,
    pca_dim: int | None = 128,
    knn_k: int = 3,
    knn_sigma_um: float = 60.0,
    seed: int = 0,
) -> np.ndarray:
    """Full branch: sample -> embed -> PCA -> Gaussian-KNN impute.

    coords_um: [N_kept, 2] micron coordinates of the kept (non-isolated)
    cells; kept_idx maps kept positions to original cell ids for the patch
    source. Returns [N_kept, D] float32.
    """
    n_kept = len(coords_um)
    if patch_source is None:
        patch_source = BlankPatchSource(num_cells=int(kept_idx.max()) + 1 if len(kept_idx) else 0)
    if extractor is None:
        extractor = default_foundation_extractor()

    rng = np.random.default_rng(seed)
    if sample_count is not None:
        m = max(1, min(int(sample_count), n_kept))
    else:
        m = max(1, min(int(round(float(sample_frac or 0.2) * n_kept)), n_kept))
    sampled_local = np.sort(rng.choice(n_kept, size=m, replace=False))
    sampled_global = np.asarray(kept_idx)[sampled_local]

    feats = embed_sampled_cells(patch_source, sampled_global.tolist(), extractor)
    if pca_dim is not None:
        feats = pca_reduce(feats, int(pca_dim))
    return gaussian_knn_impute(
        coords_um, sampled_local, feats, k=knn_k, sigma_um=knn_sigma_um
    )
