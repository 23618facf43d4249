"""Inference engines of the port and the classifier's run over slides."""

from .cells import CellEngine
from .runner import ClassifierEngine, run_inference
from .stitch import TileRemapStitcher, make_map_postprocess

__all__ = [
    "CellEngine", "ClassifierEngine", "TileRemapStitcher", "make_map_postprocess",
    "run_inference",
]
