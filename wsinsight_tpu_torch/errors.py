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


# Queue 1 items of ROADMAP.md that parts of the JAX package wait for in the port.
_QUEUE_1 = {
    10: "scale and tooling",
}


def not_ported(what: str, item: int) -> str:
    """The message for a part of the JAX package the port does not have yet,
    naming the ROADMAP.md Queue 1 item it waits for."""
    return f"{what} is not yet ported to torch (ROADMAP.md, Queue 1, item {item}: {_QUEUE_1[item]})"
