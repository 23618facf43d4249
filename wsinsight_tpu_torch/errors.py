"""Exception hierarchy for the PyTorch port (a copy of wsinsight_tpu.errors).

Mirrors the reference error surface (reference: wsinsight/errors.py:6-47) so that
callers of the original package find the same exception names and semantics.
"""

from __future__ import annotations


class WsinsightException(Exception):
    """Root exception for all wsinsight-tpu errors."""


class UnknownArchitectureError(WsinsightException):
    """Raised when a model architecture name is not implemented."""


class WholeSlideImageDirectoryNotFound(WsinsightException, FileNotFoundError):
    """Raised when the directory of whole slide images does not exist."""


class DuplicateFilePrefixesFound(WsinsightException):
    """Raised when two slides share a stem (e.g. slide.svs and slide.tif)."""


class WholeSlideImagesNotFound(WsinsightException, FileNotFoundError):
    """Raised when no whole slide images are found in a directory."""


class ResultsDirectoryNotFound(WsinsightException, FileNotFoundError):
    """Raised when the results directory does not exist."""


class PatchDirectoryNotFound(WsinsightException, FileNotFoundError):
    """Raised when the patches directory is missing from the results directory."""


class CannotReadSpacing(WsinsightException):
    """Raised when the physical spacing (MPP) cannot be read from a slide."""


class NoBackendException(WsinsightException):
    """Raised when no slide-reading backend is available."""


class BackendNotAvailable(WsinsightException):
    """Raised when the requested slide backend is not installed/usable."""
