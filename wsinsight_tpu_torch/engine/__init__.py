"""Inference engines of the port."""

from .cells import CellEngine
from .runner import ClassifierEngine
from .stitch import TileRemapStitcher, make_map_postprocess

__all__ = ["CellEngine", "ClassifierEngine", "TileRemapStitcher", "make_map_postprocess"]
