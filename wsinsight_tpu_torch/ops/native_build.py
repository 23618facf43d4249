"""Build and load the port's host library, ``native/*.cpp``.

The six sources (``tiledec``, ``lzw``, ``resize``, ``yuv``, ``watershed``,
``leiden``) compile with one ``g++`` into one shared library with a plain C interface,
loaded with ``ctypes``:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared
        -o build/wsinsight_tpu_torch/libwsinsight_native-<hash>.so
        tiledec.cpp lzw.cpp resize.cpp yuv.cpp watershed.cpp leiden.cpp -ljpeg -lz

It is named and built as ``cuda_build`` builds the kernels
(``hashed_library_path``, ``compile_libraries``): at first use, never at
import; a hash of the sources and flags in the name (with the compiler's
version and the CPU that ``-march=native`` resolves to, so a build directory
copied to another machine is not reused there); a temporary file renamed
onto it. Before the first build, a one-line ``g++`` link probes for libjpeg.
Where there is none, the library is built with ``-DWSI_NO_JPEG`` and without
``-ljpeg``: its region reader then declines JPEG pages, which decode through
the slide's Python tile path, and ``jpeg_linked()`` says so. A failed build or
load raises, with the compiler's or the loader's message.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

from . import cuda_build

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
NATIVE_SOURCES = ("tiledec.cpp", "lzw.cpp", "resize.cpp", "yuv.cpp", "watershed.cpp",
                  "leiden.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
NO_JPEG_FLAG = "-DWSI_NO_JPEG"
_JPEG_PROBE = "#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_decompress_struct c; jpeg_create_decompress(&c); return 0; }\n"


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host library (native/*.cpp) needs it")
    return gxx


@functools.lru_cache(maxsize=None)
def jpeg_available() -> bool:
    """Whether ``g++`` compiles and links a program against libjpeg here."""
    probe = subprocess.run([_gxx(), "-x", "c++", "-", "-o", "/dev/null", "-ljpeg"],
                           input=_JPEG_PROBE, capture_output=True, text=True, timeout=120)
    return probe.returncode == 0


def flags() -> tuple[str, ...]:
    """The compiler flags of this host's build."""
    return GXX_FLAGS if jpeg_available() else (*GXX_FLAGS, NO_JPEG_FLAG)


def libraries() -> tuple[str, ...]:
    return ("-ljpeg", "-lz") if jpeg_available() else ("-lz",)


@functools.lru_cache(maxsize=None)
def _target() -> tuple[str, ...]:
    """The compiler's version and what -march=native means on this host."""
    version = subprocess.run([_gxx(), "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[:1]
    target = subprocess.run([_gxx(), "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60).stdout
    return (*version, *(ln.split()[-1] for ln in target.splitlines()
                        if ln.strip().startswith("-march=")))


def library_path() -> Path:
    """Where this host's build of the library is (or will be)."""
    return cuda_build.hashed_library_path(
        "wsinsight_native", [NATIVE_DIR / s for s in NATIVE_SOURCES],
        (*flags(), *libraries(), *_target()))


def command(out) -> list[str]:
    """The ``g++`` command that builds the library into ``out``."""
    return [_gxx(), *flags(), "-o", str(out), *(str(NATIVE_DIR / s) for s in NATIVE_SOURCES),
            *libraries()]


def build() -> str:
    """Build the library unless it is built; returns g++'s output ("" when
    it was already built). Raises with that output if g++ fails."""
    return cuda_build.compile_libraries({"native": (command, library_path())})["native"]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    build()
    path = library_path()
    try:
        return ctypes.CDLL(str(path))
    except OSError as err:
        raise RuntimeError(f"cannot load the host library {path}: {err}") from err
