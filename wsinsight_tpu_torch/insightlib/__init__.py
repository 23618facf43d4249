"""Spatial analytics: H-Plot tumor-border metrics and CME graph clustering.

Counterpart of wsinsight_tpu/insightlib/. H-Plot, the graph build and the
Voronoi merge run on the host (copies of the JAX package's numpy/scipy/cv2);
CME's DGI training, kNN graph and the H-Optimus extractor run on the card.
"""

from .cme import cme_generation
from .hplot import hplot_generation

__all__ = ["cme_generation", "hplot_generation"]
