"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/wsinsight_tpu_torch/lib<name>-<hash>.so

The library lands in ``build/wsinsight_tpu_torch/`` at the root of the
checkout, named by a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time: the
CPU tests import every module on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wsinsight_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Every kernel source of the port; build() compiles them all at once.
KERNEL_SOURCES = ("fused_preprocess.cu",)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path(source: str) -> Path:
    """Where ``source``'s library is (or will be) built."""
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together. Returns each source's compiler output ("" when the
    library was already built). Raises if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {name: "" for name in sources}
    procs: dict[str, tuple[subprocess.Popen, Path, Path]] = {}
    try:
        for name in sources:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs[name] = (proc, tmp, target)
        for name, (proc, tmp, target) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
            os.replace(tmp, target)  # atomic: concurrent builders race safely
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build((source,))
    return ctypes.CDLL(str(library_path(source)))
