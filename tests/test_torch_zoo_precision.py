"""WSINSIGHT_PRECISION in both engines, and a zoo classifier from slide to
GeoJSON, the port against the JAX package.

The precision tests run a seeded ResNet34 (and the port's seeded
CellViT-256): "high", "float32" and "highest" are parity bit for bit and
match the JAX engine under the same value within 2e-4; "default" allows TF32
around the step only. The slide test runs both CLIs' `run --geojson
--omecsv` with a seeded InceptionV4 on `purple_slide`. The port runs on the
CPU."""

import json

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from test_torch_zoo_classifiers import ENV, INCEPTION_MODEL, _local_model  # noqa: E402
from wsinsight_tpu.engine.runner import ClassifierEngine as JaxEngine  # noqa: E402
from wsinsight_tpu.zoo import load_local_model as jax_load_local  # noqa: E402
from wsinsight_tpu_torch.engine import CellEngine, ClassifierEngine  # noqa: E402
from wsinsight_tpu_torch.zoo import load_local_model, make_random_local_model  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


# --- WSINSIGHT_PRECISION ------------------------------------------------------


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    """A seeded ResNet34 with the breast-tumor config at 64 px resized to 32."""
    return _local_model(tmp_path_factory.mktemp("rn"), "breast-tumor-resnet34.tcga-brca",
                        "resnet34", 64, 32)


@pytest.fixture(scope="module")
def resnet_patches():
    return np.random.default_rng(5).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("value", ["high", "float32", "highest"])
def test_precision_float32_values_equal_parity(resnet, resnet_patches, monkeypatch, value):
    """"high", "float32" and "highest" are parity: bit for bit the unset
    run's probabilities, and the JAX engine's under the same value within
    2e-4."""
    unset = ClassifierEngine(load_local_model(*resnet), device="cpu").run_batch(resnet_patches, 4)
    monkeypatch.setenv("WSINSIGHT_PRECISION", value)
    engine = ClassifierEngine(load_local_model(*resnet), device="cpu")
    assert engine.allow_tf32 is False
    got = engine.run_batch(resnet_patches, 4)
    np.testing.assert_array_equal(got, unset)
    want = JaxEngine(jax_load_local(*resnet), max_devices=1).run_batch(resnet_patches, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def _record_flags(engine) -> list:
    """Wrap the engine's model so each forward records the TF32 flags it ran
    under: (CUDA matmul, cuDNN)."""
    seen, forward = [], engine.model.forward

    def recording(x):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return forward(x)

    engine.model.forward = recording
    return seen


@pytest.mark.parametrize("value,tf32", [("default", True), ("high", False), ("", False)])
def test_precision_sets_tf32_around_the_step(resnet, resnet_patches, monkeypatch, value, tf32):
    """The engine's step runs under its own TF32 setting and gives the
    process's flags back afterwards; "default" allows TF32."""
    monkeypatch.setenv("WSINSIGHT_PRECISION", value)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    engine = ClassifierEngine(load_local_model(*resnet), device="cpu")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved
    seen = _record_flags(engine)
    engine.dispatch(engine.put(resnet_patches))
    engine.run_batch(resnet_patches, 4)
    assert seen == [(tf32, tf32)] * 2
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved


def test_precision_engines_keep_their_own(resnet, resnet_patches, monkeypatch):
    """Two engines of different settings in one process: each step runs
    under its own engine's flags, whichever engine was built last; the
    "default" engine stays within the bf16 bar (0.01) of parity."""
    monkeypatch.setenv("WSINSIGHT_PRECISION", "default")
    tf32 = ClassifierEngine(load_local_model(*resnet), device="cpu")
    monkeypatch.setenv("WSINSIGHT_PRECISION", "highest")
    exact = ClassifierEngine(load_local_model(*resnet), device="cpu")
    seen_tf32, seen_exact = _record_flags(tf32), _record_flags(exact)
    for _ in range(2):
        p_tf32 = tf32.run_batch(resnet_patches, 4)
        p_exact = exact.run_batch(resnet_patches, 4)
    assert seen_tf32 == [(True, True)] * 2 and seen_exact == [(False, False)] * 2
    assert np.abs(p_tf32 - p_exact).max() <= 0.01


@pytest.mark.parametrize("value", ["fastest", "bfloat16", "tensorfloat32", "HIGH"])
def test_precision_bad_value_raises(resnet, monkeypatch, value):
    monkeypatch.setenv("WSINSIGHT_PRECISION", value)
    with pytest.raises(ValueError, match="WSINSIGHT_PRECISION"):
        ClassifierEngine(load_local_model(*resnet), device="cpu")


@pytest.fixture(scope="module")
def cell_model(tmp_path_factory):
    """The port's seeded CellViT-256 at 64 px (its own checkpoint)."""
    return make_random_local_model("cellvit-256", 6, tmp_path_factory.mktemp("cell"),
                                   patch_size_pixels=64)


@pytest.mark.parametrize("value,tf32", [("high", False), ("float32", False), ("highest", False),
                                        ("default", True)])
def test_cell_engine_precision(cell_model, monkeypatch, value, tf32):
    """CellEngine takes the same values: the float32 ones give the unset
    run's maps bit for bit, and every value sets its flags around the step
    only."""
    x = np.random.default_rng(6).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    unset = CellEngine(load_local_model(*cell_model), device="cpu").run_batch(x)
    monkeypatch.setenv("WSINSIGHT_PRECISION", value)
    engine = CellEngine(load_local_model(*cell_model), device="cpu")
    seen = _record_flags(engine)
    got = engine.run_batch(x)
    assert seen == [(tf32, tf32)]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != (True, True)
    if not tf32:
        for k, v in unset.items():
            assert torch.equal(got[k], v), k


# --- slide to CSV through the CLI -----------------------------------------------


@pytest.fixture(scope="module")
def inception_runs(purple_slide, tmp_path_factory):
    """(port results, JAX results) of each CLI's `run --geojson --omecsv` on
    purple_slide with a seeded inception_v4 (350 px patches resized to 80).
    The GeoJSON ids come from a counter and the gzip mtime is fixed, the
    same in both runs."""
    import gzip
    import types
    import uuid

    from click.testing import CliRunner

    from wsinsight_tpu.cli.cli import cli as jax_cli
    from wsinsight_tpu_torch.cli.cli import cli as port_cli

    out = tmp_path_factory.mktemp("inc_runs")
    cfg, weights = _local_model(out / "model", INCEPTION_MODEL, "inception_v4", 350, 80,
                                head_scale=100.0)
    mp = pytest.MonkeyPatch()
    mp.setenv("WSINFER_FORCE_CPU", "1")
    for var in ENV:
        mp.delenv(var, raising=False)
    mp.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1.7e9))
    try:
        for name, cli in (("port", port_cli), ("jax", jax_cli)):
            ids = iter(range(1, 1 << 20))
            mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids), version=4))
            res = CliRunner().invoke(
                cli, ["run", "-i", str(purple_slide.parent), "-o", str(out / name), "--config",
                      str(cfg), "--model-path", str(weights), "-b", "64", "--geojson",
                      "--omecsv", "--export-workers", "1"],
                catch_exceptions=False)
            assert res.exit_code == 0, res.output
    finally:
        mp.undo()
    return out / "port", out / "jax"


def test_run_inception_matches_jax(inception_runs):
    import h5py

    port, jax_res = inception_runs
    with h5py.File(port / "patches" / "purple.h5", "r") as p, \
            h5py.File(jax_res / "patches" / "purple.h5", "r") as j:
        np.testing.assert_array_equal(p["/coords"][()], j["/coords"][()])
        assert p["/coords"].shape == (144, 2)
    p = pd.read_csv(port / "model-outputs-csv" / "purple.csv")
    j = pd.read_csv(jax_res / "model-outputs-csv" / "purple.csv")
    cols = ["minx", "miny", "width", "height"]
    assert list(p.columns) == list(j.columns) == cols + ["prob_Other", "prob_Tumor"]
    np.testing.assert_array_equal(p[cols].to_numpy(), j[cols].to_numpy())
    probs = p[["prob_Other", "prob_Tumor"]].to_numpy()
    assert np.isfinite(probs).all() and 0.01 < probs.min() and probs.max() < 0.99
    np.testing.assert_allclose(probs, j[["prob_Other", "prob_Tumor"]].to_numpy(), rtol=0,
                               atol=2e-4)


def test_run_inception_exports_match_jax(inception_runs):
    """The slide's GeoJSON (tiles, one feature per CSV row, its measurements
    the row's probabilities, its box the patch's own at no overlap) and
    OME-CSV next to the JAX CLI's: the same features and rows, the same
    geometry and text around the probabilities, which are within 2e-4 (the
    CSVs' own bar; on identical CSVs the files are byte-identical,
    tests/test_torch_exports.py)."""
    import gzip

    port, jax_res = inception_runs
    csv = pd.read_csv(port / "model-outputs-csv" / "purple.csv")
    gj = {k: json.loads((r / "model-outputs-geojson" / "purple.geojson").read_text())["features"]
          for k, r in (("port", port), ("jax", jax_res))}
    assert len(gj["port"]) == len(gj["jax"]) == len(csv) == 144
    for feat, want, row in zip(gj["port"], gj["jax"], csv.itertuples()):
        assert feat["geometry"] == want["geometry"] and feat.keys() == want.keys()
        props = feat["properties"]
        assert props.keys() == want["properties"].keys() and props["objectType"] == "tile"
        assert list(props["measurements"]) == ["prob_Other", "prob_Tumor"]
        np.testing.assert_array_equal(  # the writer reads the CSV as float32
            np.float32(list(props["measurements"].values())),
            np.float32([row.prob_Other, row.prob_Tumor]))
        np.testing.assert_allclose(list(props["measurements"].values()),
                                   list(want["properties"]["measurements"].values()), atol=2e-4)
        ring = np.asarray(feat["geometry"]["coordinates"][0])
        assert (ring.min(0) == [row.minx, row.miny]).all()
        assert (ring.max(0) == [row.minx + row.width, row.miny + row.height]).all()
    lines = {k: gzip.decompress((r / "model-outputs-omecsv" / "purple.ome.csv.gz").read_bytes())
             .decode().split("\n") for k, r in (("port", port), ("jax", jax_res))}
    assert lines["port"][0] == lines["jax"][0] == (
        "object,secondary_object,polygon,objectType,classification,prob_Other,prob_Tumor")
    assert len(lines["port"]) == len(lines["jax"]) == 1 + len(csv)
    for a, b in zip(lines["port"][1:], lines["jax"][1:]):
        head_a, *probs_a = a.rsplit(",", 2)
        head_b, *probs_b = b.rsplit(",", 2)
        assert head_a == head_b
        np.testing.assert_allclose(np.float64(probs_a), np.float64(probs_b), atol=2e-4)
