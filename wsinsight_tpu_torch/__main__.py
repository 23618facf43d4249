"""Module entry: `python -m wsinsight_tpu_torch` (reference: wsinsight/__main__.py:14-27)."""

from __future__ import annotations

import os
import sys


def main() -> None:
    # Avoid BLAS/OpenCV thread oversubscription — the pipeline manages its own
    # pools and the card does the heavy math.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    from .cli.cli import cli

    try:
        cli()
    except Exception as err:
        print(f"error: {err}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
