"""The comparison that decides ``correct``, on the CPU at sizes a test run
holds: the reference against the port where both compute in float32; a
whole run of each driver (the look for a card skipped) that comes out
correct, and the same run with its timed path broken underneath (an answer
altered where it is produced) that does not; and the
control, the reference in fp8 in the program's place, failing the limit of
the bf16 classifier."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench.common import Weights, seeded_state_dict
from portbench.run import run_cell

TINY_SAM = dict(embed_dim=64, depth=4, num_heads=2, window_size=14, global_attn_indexes=[1, 3],
                extract_layers=[1, 2, 3, 4])
SMALL_SLIDE_CLASSIFIER = {"side": 4096, "mpp": 0.25, "tissue": 0.5, "noise": 17, "seed": 5}
SMALL_SLIDE_CELLS = {"side": 2048, "mpp": 0.25, "tissue": 0.5, "noise": 17, "seed": 6,
                     "nuclei_per_px2": 1 / 3600, "nucleus_radii": [8, 16]}


@pytest.fixture
def tiny_sam(monkeypatch):
    """SAM-H's CellViT at a width of 64 and a depth of 4, windows of 14 and
    two global blocks: the same layers, small enough for the CPU."""
    from wsinsight_tpu_torch.models import cellvit, vit

    monkeypatch.setitem(cellvit._VARIANTS, "sam-h", vit.ViTConfig(
        TINY_SAM["embed_dim"], TINY_SAM["depth"], TINY_SAM["num_heads"],
        use_rel_pos=True, use_cls_token=False,
        global_attn_indexes=tuple(TINY_SAM["global_attn_indexes"]),
        extract_layers=tuple(TINY_SAM["extract_layers"])))


def _classifier_cell(small_cell, workload, seconds=0.5):
    ctx, bench = small_cell(workload, seconds=seconds, config={"batch": 8, "decode_threads": 2},
                            traffic={"slide": SMALL_SLIDE_CLASSIFIER, "batches": 2,
                                     "warmup_batches": 1})
    return ctx, bench


def _cells_cell(small_cell):
    ctx, bench = small_cell("samh-stream", seconds=0.5,
                            traffic={"slide": SMALL_SLIDE_CELLS, "warmup_batches": 1})
    ctx.config["widths"] = {**ctx.config["widths"], **TINY_SAM}
    ctx.config.update(batch=8, nuclei_head={"probe_patches": 8})
    ctx.config["check"] = {**ctx.config["check"], "batch_of_first": 4, "batches": 1,
                           "square_patches": 2}
    return ctx, bench


def test_reference_classifier_is_the_port_in_parity():
    from wsinsight_tpu_torch.engine import ClassifierEngine
    from wsinsight_tpu_torch.models import create_model
    from wsinsight_tpu_torch.zoo import get_registered_model

    from portbench.reference import classifier

    cfg = get_registered_model("breast-tumor-resnet34.tcga-brca").config
    with torch.device("meta"):
        meta = create_model(cfg.architecture, cfg.num_classes)
    sd = seeded_state_dict(meta, 3, torch.device("cpu"))
    sd["fc.weight"].mul_(1e-3)
    patches = np.random.default_rng(0).integers(0, 256, (4, 350, 350, 3), dtype=np.uint8)
    got = ClassifierEngine(Weights(cfg, sd), device="cpu").run_batch(patches, 4)
    ref = {"resize": 224, "mean": [0.7238, 0.5716, 0.6779], "std": [0.112, 0.1459, 0.1089],
           "layers": [3, 4, 6, 3]}
    want = classifier.probabilities(patches, sd, ref, torch.device("cpu"))
    assert np.abs(got - want).max() <= 1e-5


def test_reference_cellvit_is_the_port_in_float32(tiny_sam):
    from wsinsight_tpu_torch.engine.cells import CellEngine
    from wsinsight_tpu_torch.models import create_model
    from wsinsight_tpu_torch.zoo import get_registered_model

    from portbench.reference.cellvit import SamCellViT, maps

    cfg = get_registered_model("CellViT-SAM-H-x40-AMP").config
    with torch.device("meta"):
        meta = create_model(cfg.architecture, cfg.num_classes, halo_size=46, img_size=256)
    sd = seeded_state_dict(meta, 4, torch.device("cpu"))
    patches = np.random.default_rng(1).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    out = CellEngine(Weights(cfg, sd), device="cpu").run_batch(patches)
    widths = {"num_heads": TINY_SAM["num_heads"], "depth": TINY_SAM["depth"],
              "global_attn_indexes": TINY_SAM["global_attn_indexes"], "window_size": 14,
              "extract_layers": TINY_SAM["extract_layers"], "patch_size": 16}
    r_np, r_hv, r_tp = maps(SamCellViT(sd, widths), patches, 46, torch.device("cpu"))
    assert torch.allclose(torch.softmax(out["nuclei_binary_map"], 1)[:, 1], r_np, atol=1e-4)
    assert torch.allclose(out["hv_map"], r_hv, atol=1e-4, rtol=1e-4)
    assert torch.allclose(torch.softmax(out["nuclei_type_map"], 1), r_tp, atol=1e-4)


def test_classifier_run_is_correct_and_an_altered_answer_is_not(small_cell, monkeypatch):
    from wsinsight_tpu_torch.engine.runner import ClassifierEngine

    ctx, bench = _classifier_cell(small_cell, "resnet34-resident-parity")
    result = run_cell(ctx, bench, "cpu", time.time())
    assert result["correct"], result["checked"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"resident_patches_per_s", "setup_s"}

    step = ClassifierEngine._step

    def altered(self, batch, replica=0):
        probs = step(self, batch, replica).clone()
        probs[0] = torch.flip(probs[0], (0,)) + 0.01 * torch.tensor([1.0, -1.0])
        return probs

    monkeypatch.setattr(ClassifierEngine, "_step", altered)
    ctx, bench = _classifier_cell(small_cell, "resnet34-resident-parity")
    result = run_cell(ctx, bench, "cpu", time.time())
    assert not result["correct"], result["checked"]


def test_classifier_bf16_holds_and_its_control_fails(small_cell):
    from portbench.drivers import classifier_resident as driver

    ctx, _ = _classifier_cell(small_cell, "resnet34-resident")
    state = driver.setup(ctx)
    run = driver.window(state, ctx)
    driver.free(state, ctx)
    limit = ctx.config["limits"]["max_abs_dp"]
    assert driver.check(state, run, ctx)["max_abs_dp"] <= limit
    assert driver.check(state, run, ctx, control="fp8")["max_abs_dp"] > limit


def test_cell_run_is_correct_and_an_altered_answer_is_not(small_cell, tiny_sam, monkeypatch):
    from wsinsight_tpu_torch.engine.cells import CellEngine

    ctx, bench = _cells_cell(small_cell)
    result = run_cell(ctx, bench, "cpu", time.time())
    assert result["correct"], result["checked"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"slide_patches_per_s", "setup_s"}

    step = CellEngine._step

    def altered(self, batch, replica=0):
        out = dict(step(self, batch, replica))
        out["nuclei_type_map"] = out["nuclei_type_map"].roll(1, dims=1)
        return out

    monkeypatch.setattr(CellEngine, "_step", altered)
    ctx, bench = _cells_cell(small_cell)
    result = run_cell(ctx, bench, "cpu", time.time())
    assert not result["correct"] and result["checked"]["tp_mean_gap"]["value"] > \
        result["checked"]["tp_mean_gap"]["limit"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "resnet34-resident",
                          "--seed", str(2**31 + 9), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checked"


@pytest.mark.cuda
def test_the_parity_control_fails_on_the_card(card):
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload",
                          "resnet34-resident-parity", "--control", "tf32", "--seconds", "1",
                          "--seeds", str(2**31 + 11)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limit = json.loads((ROOT / "portbench/configs/breast-tumor-resnet34-parity.json")
                       .read_text())["limits"]["max_abs_dp"]
    assert line["lower"]["max_abs_dp"] <= limit < line["upper"]["max_abs_dp"]


def test_a_slide_whose_instances_are_not_the_first_ones_fails():
    from portbench.drivers.cell_stream import PROB_TOL, _instance_gap

    rng = np.random.default_rng(3)
    boxes = rng.integers(0, 4000, (50, 4))
    probs = rng.dirichlet(np.ones(6), 50).astype(np.float32)
    first = {"boxes": boxes, "probs": probs}
    order = rng.permutation(50)
    assert _instance_gap(first, {"boxes": boxes[order], "probs": probs[order]}) == 0.0
    moved = probs.copy()
    moved[7] += np.float32(2 * PROB_TOL)
    assert _instance_gap(first, {"boxes": boxes, "probs": moved}) > PROB_TOL
    shifted = boxes.copy()
    shifted[3, 0] += 1
    assert _instance_gap(first, {"boxes": shifted, "probs": probs}) == float("inf")
    assert _instance_gap(first, {"boxes": boxes[1:], "probs": probs[1:]}) == float("inf")


def test_set_up_inputs_are_cached_once_and_read_back(tmp_path, monkeypatch):
    import portbench.slides as slides

    monkeypatch.setattr(slides, "CACHE_DIR", tmp_path)
    calls = []

    def make():
        calls.append(1)
        return {"coords": np.arange(8).reshape(4, 2), "images": np.ones((4, 3, 3, 3), np.uint8)}

    first = slides.cached("decoded", {"side": 1}, make)
    again = slides.cached("decoded", {"side": 1}, make)
    other = slides.cached("decoded", {"side": 2}, make)
    assert len(calls) == 2 and len(list(tmp_path.iterdir())) == 2
    assert np.array_equal(first["coords"], again["coords"])
    assert np.array_equal(again["images"], other["images"])
