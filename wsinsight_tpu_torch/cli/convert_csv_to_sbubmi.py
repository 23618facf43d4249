"""Export model-output CSVs to Stony Brook BMI viewer formats.

A copy of wsinsight_tpu/cli/convert_csv_to_sbubmi.py: the port imports nothing of that package.

Same capability as the reference's legacy ``tosbu`` exporter (reference:
wsinsight/cli/convert_csv_to_sbubmi.py:1-439); the JSON field names and the
text-file column layouts below are the SBU viewer's wire contract, the code
is our own. Output tree:

single class:
    heatmap_json/heatmap-SLIDEID.json + meta-SLIDEID.json
    heatmap_txt/{color-SLIDEID, prediction-SLIDEID}
multi class: one subdirectory per class label.

Like the reference, the command is implemented but not registered on the CLI
group (reference: cli/cli.py:53); import ``tosbu`` to use it.
"""

from __future__ import annotations

import json
import random
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import click
import numpy as np
import pandas as pd

from ..wsi import get_wsi_cls

_SKIP_CLASSES = frozenset({"notils", "notumor"})


def _version_stamp(run_metadata: dict) -> dict:
    """Git + model-weights provenance block shared by heatmap and meta files."""
    stamp = dict((run_metadata.get("runtime") or {}).get("git") or {})
    weights = run_metadata.get("model_weights") or {}
    stamp.update(
        model_path=weights.get("weights_file"),
        model_hash=weights.get("weights_sha256"),
        model_url=weights.get("weights_url"),
        model_ver=None,
    )
    return stamp


def _provenance(
    *, execution_id: str, study_id: str, case_id: str, subject_id: str,
    run_metadata: dict, version: dict,
) -> dict:
    analysis = {
        "source": "computer", "execution_id": execution_id,
        "cancer_type": "quip", "study_id": study_id,
        "computation": "heatmap",
        "execution_time": run_metadata.get("timestamp"),
    }
    return {
        "analysis": analysis,
        "image": {"case_id": case_id, "subject_id": subject_id},
        "version": version,
    }


def write_heatmap_and_meta_json_lines(
    input: str | Path,
    output_heatmap: str | Path, output_meta: str | Path,
    slide_width: int, slide_height: int,
    execution_id: str, study_id: str,
    case_id: str, subject_id: str,
    class_name: str, run_metadata: dict,
) -> None:
    """Write the JSON-lines heatmap + meta files for one slide.

    Geometry is emitted in slide-normalized coordinates (everything except
    ``footprint``, which stays in base pixels) — the SBU viewer convention.
    """
    stamp_epoch = int(time.time())
    version = _version_stamp(run_metadata)
    provenance = _provenance(
        execution_id=execution_id, study_id=study_id, case_id=case_id,
        subject_id=subject_id, run_metadata=run_metadata, version=version,
    )

    table = pd.read_csv(input)
    prob_col = f"prob_{class_name}"
    if prob_col not in table.columns:
        raise KeyError(f"class name not found in results: {class_name}")

    # Vectorized normalization; one row of floats per patch.
    x0 = table["minx"].to_numpy(float) / slide_width
    y0 = table["miny"].to_numpy(float) / slide_height
    w = table["width"].to_numpy(float) / slide_width
    h = table["height"].to_numpy(float) / slide_height
    x1, y1 = x0 + w, y0 + h
    footprint = (table["width"] * table["height"]).to_numpy()
    probs = table[prob_col].to_numpy(float)

    with open(output_heatmap, "w") as sink:
        for i in range(len(table)):
            ring = [
                (x1[i], y0[i]), (x1[i], y1[i]), (x0[i], y1[i]),
                (x0[i], y0[i]), (x1[i], y0[i]),
            ]
            heat_params = {
                "human_weight": -1, "metric_array": [probs[i]],
                "heatname_array": [class_name], "weight_array": ["1"],
            }
            feature = {
                "type": "Feature", "parent_id": "self",
                "object_type": "heatmap_multiple",
                "x": (x0[i] + x1[i]) / 2, "y": (y0[i] + y1[i]) / 2,
                "normalized": "true", "footprint": int(footprint[i]),
                "geometry": {"coordinates": [ring], "type": "Polygon"},
                "provenance": provenance,
                "bbox": [x0[i], y0[i], x1[i], y1[i]],
                "properties": {
                    "multiheat_param": heat_params,
                    "metric_value": probs[i],
                    "metric_type": "tile_dice", "human_mark": -1,
                },
                "date": {"$date": stamp_epoch},
            }
            sink.write(json.dumps(feature) + "\n")

    meta = {
        "color": "yellow", "title": execution_id,
        "image": {"case_id": case_id, "subject_id": subject_id},
        "provenance": {
            "analysis_execution_id": execution_id,
            "analysis_execution_date": run_metadata.get("timestamp"),
            "study_id": study_id, "type": "computer", "version": version,
        },
        "submit_date": {"$date": stamp_epoch}, "randval": random.uniform(0, 1),
    }
    Path(output_meta).write_text(json.dumps(meta))


def write_heatmap_txt(input: str | Path, output: str | Path, class_names: list[str]) -> None:
    """Per-patch center coordinates + class probabilities, space-separated."""
    table = pd.read_csv(input)
    out = pd.DataFrame(
        {
            "x_loc": (table.minx + table.width / 2).round().astype(int),
            "y_loc": (table.miny + table.height / 2).round().astype(int),
        }
    )
    for name in class_names:
        out[name] = table[f"prob_{name}"]
    out.to_csv(output, index=False, sep=" ")


def _patch_color_stats(arr: np.ndarray) -> tuple[float, float, float]:
    """(whiteness, blackness, redness) of one RGB patch — the SBU trio:
    mean per-channel stddev, global mean, and the fraction of saturated-red
    pixels (R>=190, G<=100, B<=100)."""
    white = float(np.std(arr, axis=(0, 1)).mean())
    black = float(arr.mean())
    red_mask = (arr[..., 0] >= 190) & (arr[..., 1] <= 100) & (arr[..., 2] <= 100)
    return white, black, float(red_mask.mean())


def write_color_txt(
    input: str | Path, output: str | Path, slide, num_processes: int = 6
) -> None:
    """Whiteness/blackness/redness per patch. Threaded, not forked: the
    in-house reader decodes without the GIL (the reference used a fork pool
    plus a module-global function hack)."""
    table = pd.read_csv(input)
    boxes = table[["minx", "miny", "width", "height"]].astype(int).to_numpy()

    def stats_for(box) -> tuple[float, float, float]:
        x, y, w, h = (int(v) for v in box)
        region = slide.read_region(location=(x, y), level=0, size=(w, h))
        return _patch_color_stats(np.asarray(region))

    with ThreadPoolExecutor(max_workers=max(1, num_processes)) as pool:
        stats = list(pool.map(stats_for, boxes))

    out = pd.DataFrame(stats, columns=["whiteness", "blackness", "redness"])
    # The reference's (quirky) center math, preserved for output parity:
    # cx = minx + (minx+width)/2 rather than the true center.
    out.insert(0, "cy", (table.miny + (table.miny + table.height) / 2).astype(int))
    out.insert(0, "cx", (table.minx + (table.minx + table.width) / 2).astype(int))
    out.to_csv(output, header=False, index=False, sep=" ")


def _locate_model_outputs(results_dir: Path) -> Path:
    for name in ("model-outputs-csv", "model-outputs"):  # new then legacy layout
        candidate = results_dir / name
        if candidate.exists():
            return candidate
    raise click.ClickException(
        "No model outputs found under results_dir — run model inference first."
    )


def _load_run_metadata(results_dir: Path) -> dict:
    stamped = sorted(results_dir.glob("*_metadata_*.json"))
    legacy = results_dir / "run_metadata.json"
    candidates = stamped + ([legacy] if legacy.exists() else [])
    if not candidates:
        raise click.ClickException(f"Cannot find run metadata in {results_dir}.")
    return json.loads(candidates[-1].read_text())


def _class_names_from(run_metadata: dict) -> list[str]:
    names = (run_metadata.get("model_config") or {}).get("class_names") or (
        run_metadata.get("model_weights") or {}
    ).get("class_names", [])
    names = [n for n in names if n not in _SKIP_CLASSES]
    if not names:
        raise click.ClickException("No class names found in run metadata.")
    return names


@click.command()
@click.argument("results_dir", type=click.Path(exists=True, file_okay=False, path_type=Path))
@click.argument("output", type=click.Path(exists=False, path_type=Path))
@click.option("--wsi-dir", required=True, type=click.Path(exists=True, file_okay=False, path_type=Path))
@click.option("--execution-id", required=True, help="Unique id naming this run.")
@click.option("--study-id", required=True, help="Cohort/study id (e.g. TCGA-BRCA).")
@click.option("--make-color-text/--no-make-color-text", default=False)
@click.option("--num-processes", type=int, default=4)
def tosbu(
    *,
    results_dir: Path, output: Path, wsi_dir: Path,
    execution_id: str, study_id: str,
    make_color_text: bool = False, num_processes: int = 4,
) -> None:
    """Convert model outputs to Stony Brook BMI viewer formats."""
    if output.exists():
        raise click.ClickException("Output directory already exists.")
    model_outputs = _locate_model_outputs(results_dir)
    run_metadata = _load_run_metadata(results_dir)
    class_names = _class_names_from(run_metadata)
    csvs = sorted(model_outputs.glob("*.csv"))
    if not csvs:
        raise click.ClickException("No CSVs found. Did you generate model outputs?")
    output.mkdir(exist_ok=False)

    for index, csv_path in enumerate(csvs, start=1):
        click.echo(f"Converting outputs for slide {index} of {len(csvs)}")
        slide_id = csv_path.stem
        matches = sorted(wsi_dir.glob(f"{slide_id}.*"))
        if not matches:
            click.secho(f"WSI file not found for: {slide_id}; skipping", bg="red")
            continue
        slide = get_wsi_cls()(matches[0])
        slide_width, slide_height = slide.level_dimensions[0]

        def class_dir(root: Path, label: str) -> Path:
            # single-class runs write flat; multi-class get per-label subdirs
            return root if len(class_names) == 1 else root / label

        for label in class_names:
            json_dir = class_dir(output / "heatmap_json", label)
            json_dir.mkdir(parents=True, exist_ok=True)
            write_heatmap_and_meta_json_lines(
                input=csv_path,
                output_heatmap=json_dir / f"heatmap_{slide_id}.json",
                output_meta=json_dir / f"meta_{slide_id}.json",
                slide_width=slide_width,
                slide_height=slide_height,
                execution_id=execution_id,
                study_id=study_id,
                case_id=slide_id,
                subject_id=slide_id,
                class_name=label,
                run_metadata=run_metadata,
            )
            txt_dir = class_dir(output / "heatmap_txt", label)
            txt_dir.mkdir(parents=True, exist_ok=True)
            write_heatmap_txt(
                input=csv_path, output=txt_dir / f"prediction-{slide_id}",
                class_names=[label],
            )

        if make_color_text:
            first_dir = class_dir(output / "heatmap_txt", class_names[0])
            color_path = first_dir / f"color-{slide_id}"
            write_color_txt(
                input=csv_path, output=color_path, slide=slide,
                num_processes=num_processes,
            )
            for label in class_names[1:]:  # one decode pass, copied per label
                target = output / "heatmap_txt" / label / color_path.name
                target.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(color_path, target)
