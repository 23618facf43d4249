"""wsinsight_tpu_torch: the PyTorch/CUDA port of wsinsight_tpu.

It mirrors the layout and names of the JAX package, module for module, and
imports nothing from it (nor from jax or flax). Its hand-written CUDA kernels
live under ``ops/csrc`` and are compiled with ``nvcc`` at first use into
``build/wsinsight_tpu_torch/`` at the root of the checkout; its host library
(``native/*.cpp``) is compiled there with ``g++`` the same way.

Ported so far: the patch-classification engine (``engine.runner.
ClassifierEngine``) with its preprocess (``ops``) and every zoo classifier
(the ResNet family, VGG16, InceptionV4 with and without batch norm), with
WSINSIGHT_PRECISION; the
CellViT cell engine (``engine.cells.CellEngine``) with the SAM and ViT-256
encoders and their fused window attention (``ops.flash_attn``), and the
stitcher's device half (``engine.stitch``); weight loading
(``models.convert``, ``zoo``) and device resolution (``parallel.mesh``); and
the classifier's host stack, slide to CSV: the TIFF reader (``wsi``), tissue
segmentation and the patch grid (``patchlib``), the threaded decode
(``engine.data``), ``engine.runner.run_inference`` and the ``patch`` /
``infer`` / ``run`` CLI (``python -m wsinsight_tpu_torch``); the native
decoders (``native``) and the classifier's input options: host resize, the
YUV 4:2:0 wire, the DCT half decode and stain normalization (``ops.stain``);
and the cell path's host half, slide to nuclei: the halo grid, the
stitcher's tiled watershed finalize (``ops.hv_postproc``, ``ops.watershed``
on the native watershed, ``ops.hv_device``) and ``engine.cells.
run_cell_inference`` behind ``run_inference``'s end2end branch, by default
on the banded streaming cell engine (``engine.stream_cells``); and
infer's outputs and side branches: the GeoJSON, OME-CSV and QuPath
exporters (``writers``), the QuPath planners and pseudo-models, the
references overlay and ``tosbu`` (``cli.convert_csv_to_sbubmi``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
