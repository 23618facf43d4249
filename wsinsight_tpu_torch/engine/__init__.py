"""Inference engines of the port."""

from .runner import ClassifierEngine

__all__ = ["ClassifierEngine"]
