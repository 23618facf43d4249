"""wsinsight_tpu_torch: the PyTorch/CUDA port of wsinsight_tpu.

It mirrors the layout and names of the JAX package, module for module, and
imports nothing from it (nor from jax or flax). Its hand-written CUDA kernels
live under ``ops/csrc`` and are compiled with ``nvcc`` at first use into
``build/wsinsight_tpu_torch/`` at the root of the checkout.

Ported so far: the patch-classification engine (``engine.runner.
ClassifierEngine``) with its preprocess (``ops``), the ResNet family
(``models``), weight loading (``models.convert``, ``zoo``) and device
resolution (``parallel.mesh``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
