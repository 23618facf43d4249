"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/wsinsight_tpu_torch/lib<name>-<hash>.so

The library lands in ``build/wsinsight_tpu_torch/`` at the root of the
checkout, named by a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time: the
CPU tests import every module on hosts with no ``nvcc``.

``hashed_library_path`` and ``compile_libraries`` are the naming and the
build (temporary file, then an atomic rename) that ``native_build`` shares
for the host library.
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
KERNEL_SOURCES = ("fused_preprocess.cu", "window_attention.cu")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def hashed_library_path(stem: str, sources, flags) -> Path:
    """``build/wsinsight_tpu_torch/lib<stem>-<hash>.so``, the hash over the
    bytes of ``sources`` (paths, in order) and ``flags``."""
    digest = hashlib.sha256()
    for source in sources:
        digest.update(Path(source).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def library_path(source: str) -> Path:
    """Where ``source``'s library is (or will be) built."""
    return hashed_library_path(Path(source).stem, (CSRC_DIR / source,), NVCC_FLAGS)


def compile_libraries(jobs) -> dict[str, str]:
    """Run every job whose library is not built yet, all started together.
    ``jobs`` maps a name to ``(command, target)``, where ``command(out)`` is
    the compiler's argument list writing to ``out``. Each compiler writes a
    temporary file that is renamed onto its target, so concurrent builders
    race safely. Returns each job's compiler output ("" when the library was
    already built); raises with that output if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {name: "" for name in jobs}
    procs: dict[str, tuple[subprocess.Popen, Path, Path]] = {}
    try:
        for name, (command, target) in jobs.items():
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs[name] = (proc, tmp, target)
        for name, (proc, tmp, target) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{Path(proc.args[0]).name} failed on {name}:\n{logs[name]}")
            os.replace(tmp, target)  # atomic: concurrent builders race safely
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


def build(sources: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together. Returns each source's compiler output ("" when the
    library was already built). Raises if any compilation fails."""
    def job(name):
        return (lambda out: [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / name)],
                library_path(name))

    return compile_libraries({name: job(name) for name in sources})


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build((source,))
    return ctypes.CDLL(str(library_path(source)))


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of an nvcc -Xptxas=-v log: its name (demangled
    where c++filt is there), registers and spills."""
    names, stats, spill = [], [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            names.append(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and len(stats) < len(names):
            stats.append(f"{line.split('Used', 1)[1].split(',')[0].strip()}; {spill}")
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
        if len(out) == len(names):
            names = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                     for n in out]
    except (OSError, subprocess.SubprocessError):
        pass
    return [f"{n}: {st}" for n, st in zip(names, stats)]
