"""Single-cell (object-based end2end) inference: CellViT or HoVer-Net ->
stitcher -> instances.

Counterpart of wsinsight_tpu/engine/cells.py. The model is built at the
config's halo (HoVer-Net crops anything past its own 46 px) and patch
size. ``CellEngine`` has the JAX engine's surface (``config``,
``n_devices``, ``pad_batch``, ``run_batch``) plus ``put`` / ``dispatch`` as
in ``ClassifierEngine``. ``stitch_slide``
drives it over one slide's patch source one batch deep with the stitcher's
device half::

    pending = None
    for batch in src:
        pred = engine.dispatch(engine.put(batch.images))
        maps = stitcher.device_postprocess(pred)  # enqueued, not waited for
        if pending is not None:
            stitcher.scatter(*pending)  # the previous batch's transfer
        pending = (maps, batch.coords, batch.n_valid)

``run_cell_inference`` routes as the JAX package's does. By default
(WSINSIGHT_STREAM_CELLS unset or "1") it runs the banded streaming engine
(``engine/stream_cells.py``: the maps stay on the device in slide-space
bands, flusher threads run the watershed while the forwards go on) when its
bands fit the device budget (``streaming_fits``); a budget miss, or a band
that overflows the engine's instance cap (``StreamingCapacityError``, after
which the slide runs again), takes the host-canvas engine: it builds the
stitcher and the source of one slide, runs ``stitch_slide`` and the
stitcher's ``finalize`` (the tiled watershed on host threads). "0" or ""
asks for the host-canvas engine. Both give the same instances.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List

import numpy as np
import torch
import tqdm

from ..models import create_model
from ..ops.preprocess import TransformSpec, make_preprocess_fn, yuv420_to_rgb
from ..uri_path import URIPath
from ..utils.workers import governed_workers
from ..zoo import ModelHandle, randomize_cell_model
from .data import Batch, PatchBatchSource
from .runner import Replicated, precision_allows_tf32, tf32_flags
from .stitch import TileRemapStitcher

logger = logging.getLogger(__name__)


class CellEngine(Replicated):
    """(preprocess -> CellViT or HoVer-Net forward) step, one replica per
    device.

    Parity mode (the default) computes in float32 with TF32 off for matmuls
    and cuDNN convolutions; WSINSIGHT_PRECISION="default" allows TF32, set
    around each step as ``ClassifierEngine`` does. ``mixed_precision`` runs
    the model under bfloat16 autocast. On the card every attention core runs
    the K2 kernel.

    ``init_random`` gives the model ``randomize_cell_model``'s seeded weights
    (``seed``) instead of loading ``model_info``'s checkpoint, so a full-size
    SAM-H needs no file; the same seed gives the same weights on every
    device.

    The devices, the replicas, the split of a batch and the gather of the
    maps onto the first device are ``runner.Replicated``'s.
    """

    def __init__(
        self,
        model_info: ModelHandle,
        mixed_precision: bool = False,
        max_devices: int | None = None,
        init_random: bool = False,
        device: str | torch.device | None = None,
        seed: int = 0,
        devices: list[str | torch.device] | None = None,
    ):
        self.allow_tf32 = precision_allows_tf32()
        cfg = model_info.config
        self.config = cfg
        self.mixed_precision = mixed_precision
        compute_dtype = torch.bfloat16 if mixed_precision else torch.float32

        model = create_model(cfg.architecture, cfg.num_classes, dtype=compute_dtype,
                             halo_size=cfg.halo_size_pixels, img_size=cfg.patch_size_pixels)
        if init_random:
            randomize_cell_model(model, seed)
        else:
            model.load_state_dict(model_info.load_state_dict(model), strict=True)
        self._place(model, devices, device, max_devices)
        self._preprocess = make_preprocess_fn(TransformSpec.from_config(cfg.transform),
                                              compute_dtype)

    def _step(self, batch_u8: torch.Tensor, replica: int = 0) -> dict[str, torch.Tensor]:
        with torch.inference_mode(), tf32_flags(self.allow_tf32):
            if batch_u8.dim() == 3:
                # YUV 4:2:0 wire (WSINSIGHT_WIRE=yuv420): RGB is rebuilt on
                # the device; the rank says which format came.
                batch_u8 = yuv420_to_rgb(batch_u8).to(torch.uint8)
            return self.models[replica](self._preprocess(batch_u8))

    def run_batch(self, images_u8: np.ndarray) -> dict[str, torch.Tensor]:
        """(B, P, P, 3) uint8 (or the YUV wire's (B, P*3/2, P)) -> the
        model's output dict, on the first device: channel-first float32 maps
        cropped to the halo interior and the tissue logits."""
        return self.dispatch(self.put(images_u8))


def _cell_wire() -> str | None:
    """Cell-path wire format from WSINSIGHT_WIRE (yuv420 or exact RGB).

    The lossy half-scale decode is classifier-only (cell models consume the
    full-resolution patch — there is no downstream resize to hide it), so
    cell sources pin decode_scale=1 and take only the wire choice from env.
    """
    return "yuv420" if os.getenv("WSINSIGHT_WIRE", "").lower() == "yuv420" else None


def stitch_slide(
    engine: CellEngine,
    stitcher: TileRemapStitcher,
    src: PatchBatchSource,
    it: Iterator[Batch] | None = None,
) -> None:
    """One slide's patches through ``engine`` into ``stitcher``'s canvases.

    One batch deep: batch i+1's forward and device post-process are
    enqueued before batch i's maps are fetched and scattered. ``it`` is an
    iterator of ``src`` already started."""
    pending = None  # (device maps, coords, n_valid)
    with tqdm.tqdm(total=src.num_batches, desc="Inference", position=1, leave=False) as qbar:
        for batch in (iter(src) if it is None else it):
            pred = engine.dispatch(engine.put(batch.images))
            # The maps stay on the device; only the resized ones cross to
            # the host, once per batch.
            maps = stitcher.device_postprocess(
                {k: v for k, v in pred.items() if k != "tissue_types"})
            if pending is not None:
                stitcher.scatter(*pending)
                qbar.update(1)
            pending = (maps, batch.coords, batch.n_valid)
        if pending is not None:
            stitcher.scatter(*pending)
            qbar.update(1)


def slide_geometry(engine: CellEngine, mpp: float, halo_size_px: int) -> tuple[int, int]:
    """(slide patch size, slide halo size) in slide pixels at ``mpp``.
    Geometry contract of the reference (run_inference.py:309-311): the
    model's maps cover patch_px - 2*halo px at its spacing, scaled to slide
    pixels by spacing/mpp."""
    cfg = engine.config
    model_output_size_px = cfg.patch_size_pixels - 2 * halo_size_px
    return (int(round(model_output_size_px * cfg.spacing_um_px / mpp)),
            int(round(halo_size_px * cfg.spacing_um_px / mpp)))


def make_slide_stitcher(
    engine: CellEngine,
    slide_width: int,
    slide_height: int,
    mpp: float,
    halo_size_px: int,
    min_object_size: int = 20,
) -> TileRemapStitcher:
    """The host-canvas stitcher of one slide at ``mpp`` (``slide_geometry``).
    Its transfer dtype is the quantized default (uint8 NP/TP, bf16 HV;
    WSINSIGHT_CELL_TRANSFER overrides it), its ridge device the engine's."""
    cfg = engine.config
    slide_patch_size, slide_halo_size = slide_geometry(engine, mpp, halo_size_px)
    return TileRemapStitcher(
        n_classes=cfg.num_classes,
        slide_width=slide_width,
        slide_height=slide_height,
        slide_patch_size=slide_patch_size,
        slide_halo_size=slide_halo_size,
        slide_mpp=mpp,
        model_mpp=cfg.spacing_um_px,
        min_object_size=min_object_size,
        device=engine.device,
    )


def run_cell_inference(
    engine: CellEngine,
    *,
    wsi_path: URIPath,
    patch_path: URIPath,
    use_hdf5_images: bool,
    slide_width: int,
    slide_height: int,
    mpp: float,
    halo_size_px: int,
    batch_size: int,
    num_workers: int,
    stitch_workers: int | None,
    min_object_size: int = 20,
) -> tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Run the model over all patches and stitch instances.

    Returns (coords (N,4) [x,y,w,h], probs (N,K), polygons list[(Mi,2)]).
    Geometry contract matches the reference (run_inference.py:309-311):
    model_output = patch_px - 2*halo; slide sizes scaled by spacing/mpp.
    """
    cfg = engine.config
    if os.getenv("WSINSIGHT_STREAM_CELLS", "1") not in ("0", ""):
        from .stream_cells import (
            StreamingCapacityError,
            pick_num_flushers,
            run_streaming_cell_inference,
            streaming_fits,
        )

        n_flushers = pick_num_flushers(stitch_workers)
        slide_patch_size = slide_geometry(engine, mpp, halo_size_px)[0]
        if streaming_fits(slide_width, cfg.num_classes, slide_patch_size, num_flushers=n_flushers):
            try:
                return run_streaming_cell_inference(
                    engine,
                    wsi_path=wsi_path,
                    patch_path=patch_path,
                    use_hdf5_images=use_hdf5_images,
                    slide_width=slide_width,
                    slide_height=slide_height,
                    mpp=mpp,
                    halo_size_px=halo_size_px,
                    batch_size=batch_size,
                    num_workers=num_workers,
                    min_object_size=min_object_size,
                    stitch_workers=stitch_workers,
                )
            except StreamingCapacityError as err:
                logger.warning(f"streaming engine capacity exceeded ({err}); rerunning the"
                               " slide on the host-canvas path")
        else:
            logger.info("banded streaming requested but bands exceed the HBM budget; using"
                        " the host-canvas path")

    stitcher = make_slide_stitcher(engine, slide_width, slide_height, mpp, halo_size_px,
                                   min_object_size)
    src = None
    try:
        src = PatchBatchSource(
            wsi_path=wsi_path,
            patch_path=patch_path,
            use_hdf5_images=use_hdf5_images,
            batch_size=engine.pad_batch(batch_size),
            num_threads=governed_workers(num_workers or 4),
            wire=_cell_wire(),
            decode_scale=1,  # cell models take full-res patches (no resize)
        )
        stitch_slide(engine, stitcher, src)
        with tqdm.tqdm(desc="Stitching", position=1, leave=False) as qbar:
            inst, probs, polys = stitcher.finalize(pbar=qbar, num_workers=stitch_workers)
    finally:
        if src is not None:
            src.close()
        stitcher.close()

    if not inst:
        return np.zeros((0, 4), np.int32), np.zeros((0, cfg.num_classes), np.float32), []
    return np.concatenate(inst, axis=0), np.concatenate(probs, axis=0), polys
