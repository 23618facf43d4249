"""BENCHMARK.json against the benchmark's contract: every cell, mix, driver
and metric resolves to its files; names, units and lines keep their
characters and lengths; every cell reports what it must."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(word) for word in cmd)
    files = [w for w in cmd if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_resolve_and_are_unique():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert cfg["limits"] and all(v > 0 for v in cfg["limits"].values())
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=CELLS)
def test_cell_resolves_to_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.fullmatch(cell[key])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py").is_file()


def test_names_are_unique_and_a_quarter_at_most_asks_for_four_chips():
    for items in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [i["name"] for i in items]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_resolves_to_its_reader(metric):
    from portbench.common import load_module, reader_path

    assert NAME.fullmatch(metric["name"]) and UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric["workloads"]) <= set(CELLS) if "workloads" in metric else True
    reader = load_module(reader_path(metric["name"]), "m")
    assert callable(reader.read)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert _line(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
    if metric["name"].split(".")[0].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%" and metric["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_set_up_another_end_to_end_and_a_layer(cell):
    def reports(m):
        return cell in m.get("workloads", CELLS)

    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m) for m in BENCH["per_layer"])
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_a_split_metric_without_a_reader_of_its_own_reads_its_quantity():
    from portbench.common import reader_path

    metrics = ROOT / "portbench" / "metrics"
    assert reader_path("device_idle_pct.step") == metrics / "device_idle_pct.py"
    assert reader_path("mfu_pct.step") == metrics / "mfu_pct.step.py"
    assert reader_path("setup_s") == metrics / "setup_s.py"
