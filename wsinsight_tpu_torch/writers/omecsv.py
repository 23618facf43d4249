"""Model-output CSV -> gzipped OME-CSV exporter.

A copy of wsinsight_tpu/writers/omecsv.py: the port imports nothing of that package.

Output layout is a byte-level re-creation of the reference exporter
(reference: wsinsight/write_omecsv.py:52-309): header
``object,secondary_object,polygon,objectType,classification,<prob cols>``, one
WKT polygon per row from the shrink-box math, class = argmax name with the
prefix stripped, `.ome.csv.gz` outputs, resume-skip, process-pool fan-out. The
``h5s`` argument is kept for API compatibility and unused.

Unlike the reference's per-row loop, the table here is assembled column-wise
with vectorised numpy string concatenation.
"""

from __future__ import annotations

import gzip as _gzip
import multiprocessing as _mp
import pathlib as _pl
import typing as _t
from concurrent.futures import ProcessPoolExecutor, as_completed

import numpy as np
import pandas as pd
from tqdm.auto import tqdm

from ..uri_path import URIPath
from .common import iter_files, shrunk_boxes

PathLike = _t.Union[_pl.Path, URIPath]

_SUFFIX = ".ome.csv.gz"
_HEAD_COLS = ("object", "secondary_object", "polygon", "objectType", "classification")


def _zip_str(parts: list, sep: str) -> np.ndarray:
    """Element-wise join of equal-length string arrays with a separator."""
    joined = parts[0]
    for part in parts[1:]:
        joined = np.char.add(np.char.add(joined, sep), part)
    return joined


def _render_table(df: pd.DataFrame, prob_cols: list, boxes, class_prefix: str) -> str:
    """OME-CSV payload text for one slide's rows (no trailing newline).

    ``boxes`` is the (minx, miny, maxx, maxy) tuple of shrunk tile boxes; the
    WKT ring runs top-right -> bottom-right -> bottom-left -> top-left ->
    close, matching the reference byte-for-byte.
    """
    n = df.shape[0]
    if any(len(side) != n for side in boxes):
        raise ValueError("coordinate arrays and dataframe disagree on row count")

    header = ",".join([*_HEAD_COLS, *prob_cols])
    if n == 0:
        return header

    left, top, right, bottom = (
        np.asarray(side, dtype=np.int64).astype(str) for side in boxes
    )
    corners = [
        _zip_str([right, top], " "),
        _zip_str([right, bottom], " "),
        _zip_str([left, bottom], " "),
        _zip_str([left, top], " "),
    ]
    ring = _zip_str(corners + corners[:1], ",")
    wkt = np.char.add(np.char.add('"POLYGON ((', ring), '))"')

    probs = df[prob_cols].to_numpy(copy=False)
    short_names = np.asarray([c[len(class_prefix):] for c in prob_cols])
    winner = short_names[probs.argmax(axis=1)]
    scores = _zip_str([probs[:, j].astype(str) for j in range(probs.shape[1])], ",")

    seq = np.arange(n).astype(str)
    body = _zip_str([seq, seq, wkt, np.full(n, "tile"), winner, scores], ",")
    return "\n".join([header, *body.tolist()])


def _gzip_dump(dest: PathLike, payload: bytes) -> None:
    dest.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(dest, URIPath) and dest.scheme is not None:
        with dest.open("wb") as fh, _gzip.GzipFile(fileobj=fh, mode="wb") as gz:
            gz.write(payload)
    else:
        with _gzip.open(str(dest), "wb") as gz:
            gz.write(payload)


def make_omecsv(
    csv: PathLike,
    results_dir: PathLike,
    output_dir: PathLike,
    overlap: float,
    prefix: str,
    usecols: _t.Optional[list] = None,
    dtype: _t.Optional[dict] = None,
) -> None:
    """Read one model-output CSV and write `<stem>.ome.csv.gz`."""
    local = csv.materialize() if isinstance(csv, URIPath) else csv
    table = pd.read_csv(local, usecols=usecols, dtype=dtype, engine="c", low_memory=False)

    wanted = f"{prefix}_"
    prob_cols = [c for c in table.columns if c.startswith(wanted)]
    if not prob_cols:
        raise KeyError(f"Did not find any columns with '{wanted}' prefix.")
    table = table.dropna(subset=prob_cols)

    text = _render_table(table, prob_cols, shrunk_boxes(table, overlap), wanted)
    _gzip_dump(results_dir / output_dir / (csv.stem + _SUFFIX), text.encode("utf-8"))


_iter_files = iter_files


def write_omecsvs(
    csvs: _t.List[PathLike],
    h5s: _t.List[PathLike],  # API compatibility with the reference; unused
    overlap: float,
    results_dir: PathLike,
    output_dir: PathLike,
    prefix: str,
    num_workers: int,
    usecols: _t.Optional[list] = None,
    dtype: _t.Optional[dict] = None,
    show_progress: bool = True,
) -> None:
    """Convert model-output CSVs into gzipped OME-CSVs via a process pool."""
    del h5s
    out_root = results_dir / output_dir
    out_root.mkdir(parents=True, exist_ok=True)

    # Resume: a stem whose .ome.csv.gz already exists is not re-exported.
    done = {
        str(p.name)[: -len(_SUFFIX)]
        for p in _iter_files(out_root)
        if str(p.name).endswith(_SUFFIX)
    }
    todo = [p for p in csvs if p.stem not in done]
    if not todo:
        return

    # Governor clamp, mirroring the reference's governed export pool
    # (num_worker_optimizer.py:74-165 via write_omecsv.py).
    from ..utils.workers import governed_workers

    bar = tqdm(total=len(todo), desc="OME-CSVs", dynamic_ncols=True) if show_progress else None
    n_workers = governed_workers(num_workers)
    if n_workers <= 1 or len(todo) == 1:
        # Inline path: skip the spawn pool's interpreter+import startup cost
        # when it could not parallelize anything anyway (see write_geojsons).
        for p in todo:
            make_omecsv(p, results_dir, output_dir, overlap, prefix, usecols, dtype)
            if bar is not None:
                bar.update(1)
    else:
        spawn = _mp.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n_workers, mp_context=spawn) as pool:
            pending = [
                pool.submit(make_omecsv, p, results_dir, output_dir, overlap, prefix, usecols, dtype)
                for p in todo
            ]
            for fut in as_completed(pending):
                fut.result()
                if bar is not None:
                    bar.update(1)
    if bar is not None:
        bar.close()
