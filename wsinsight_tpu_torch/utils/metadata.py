"""Run-metadata capture: environment, versions, git state, model identity.

Re-creation of the reference's provenance records (reference:
wsinsight/cli/patch.py:122-193, cli/infer.py:167-238): model config + weights
identity, argv, interpreter/library versions, container detection, git
remote/branch/commit/dirty, written to `*_metadata_<timestamp>.json`.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
from datetime import datetime
from pathlib import Path
from typing import Any


def _get_git_info() -> dict[str, Any] | None:
    # Provenance of the PIPELINE CODE, not of wherever the user happens to
    # invoke the CLI from — so probe the installed package's directory.
    code_dir = str(Path(__file__).resolve().parent)

    def run(*args: str) -> str | None:
        try:
            out = subprocess.run(
                ["git", *args], capture_output=True, timeout=5, cwd=code_dir
            )
            if out.returncode != 0:
                return None
            return out.stdout.decode().strip()
        except Exception:
            return None

    inside = run("rev-parse", "--is-inside-work-tree")
    if inside != "true":
        return None
    status = run("status", "--porcelain")
    return {
        "git_remote_url": run("config", "--get", "remote.origin.url"),
        "git_branch": run("rev-parse", "--abbrev-ref", "HEAD"),
        "git_commit": run("rev-parse", "HEAD"),
        # None = unknown (git call failed), not "clean"
        "git_dirty": bool(status) if status is not None else None,
    }


def _in_container() -> bool:
    return (
        Path("/.dockerenv").exists()
        or Path("/singularity").exists()
        or Path("/.singularity.d").exists()
        or bool(os.getenv("SINGULARITY_CONTAINER"))
    )


def _devices() -> list[str]:
    """The devices the engines would run on: the CUDA cards by name, or the
    CPU where there are none or WSINFER_FORCE_CPU asks for it."""
    import torch

    from ..parallel.mesh import force_cpu_requested

    if force_cpu_requested() or not torch.cuda.is_available():
        return ["cpu"]
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]


def get_runtime_info() -> dict[str, Any]:
    import torch

    from .._version import __version__

    versions: dict[str, Any] = {
        "python": sys.version,
        "wsinsight_tpu_torch": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    for mod in ("numpy", "pandas", "h5py", "cv2", "scipy"):
        try:
            versions[mod] = __import__(mod).__version__
        except Exception:  # not installed (h5py on hosts without it): None
            versions[mod] = None
    return {
        "platform": platform.platform(),
        "in_container": _in_container(),
        "devices": _devices(),
        "versions": versions,
        "git": _get_git_info(),
    }


def get_info_for_save(model_obj: Any) -> dict[str, Any]:
    """Full provenance record for a run (model + runtime + argv)."""
    cfg = getattr(model_obj, "config", None)
    weights_path = getattr(model_obj, "weights_path", None)
    weights_sha256 = None
    if weights_path and Path(str(weights_path)).exists():
        from ..models.convert import sha256_file

        weights_sha256 = sha256_file(weights_path)
    return {
        "model_name": getattr(model_obj, "name", None),
        "model_config": cfg.to_dict() if cfg is not None else None,
        "model_weights": {
            "weights_file": str(weights_path) if weights_path else None,
            "weights_sha256": weights_sha256,
            "weights_url": getattr(model_obj, "hf_repo_id", None),
        },
        "timestamp": datetime.now().astimezone().isoformat(),
        "argv": sys.argv,
        "runtime": get_runtime_info(),
        "stage_timings_sec": _get_stage_timings(),
    }


def _get_stage_timings() -> dict:
    from .profiling import stage_timings

    return stage_timings()


def write_run_metadata(results_dir, prefix: str, model_obj: Any) -> str:
    """Write `<prefix>_metadata_<ts>.json` into results_dir; returns the path."""
    timestamp = datetime.now().astimezone().strftime("%Y%m%dT%H%M%S")
    out = results_dir / f"{prefix}_metadata_{timestamp}.json"
    with out.open("w") as f:
        json.dump(get_info_for_save(model_obj), f, indent=2)
    return str(out)


def print_system_info() -> None:
    """Console banner (reference: cli/patch.py:69-119)."""
    info = get_runtime_info()
    versions = info["versions"]
    print("\nSystem information")
    print("------------------")
    print(f"Platform: {info['platform']}")
    print(f"Python: {sys.version.split()[0]}")
    print(f"PyTorch: {versions['torch']} (CUDA {versions['cuda']})")
    print(f"Devices: {', '.join(info['devices'])}")
    print(f"Container: {info['in_container']}")
    print("------------------")
