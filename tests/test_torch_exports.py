"""infer's exporters and QuPath branches in the port, against the JAX package.

The writers (GeoJSON, OME-CSV, WKT), the QuPath planners and pseudo-models,
the references overlay, the CLI's export block and ``tosbu`` are run by both
packages on the same inputs; their files must be byte-identical. The only
patches are the nondeterministic stamps: ``uuid.uuid4`` (GeoJSON box ids),
the gzip header's ``time.time`` and ``tosbu``'s ``time.time`` /
``random.uniform``, each set through the module that calls it. Where a
process pool writes (spawn workers inherit no patch), GeoJSON ids are
compared as valid uuid4s and OME-CSVs by their gzip payload and header
outside the mtime field. The port runs on the CPU and touches no device on
the QuPath branches."""

import gzip
import json
import re
import types
import uuid

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("torch")

import wsinsight_tpu.utils.workers as jax_workers  # noqa: E402
import wsinsight_tpu_torch.utils.workers as port_workers  # noqa: E402
from wsinsight_tpu.uri_path import URIPath as JaxURIPath  # noqa: E402
from wsinsight_tpu.writers import geojson as jax_geojson  # noqa: E402
from wsinsight_tpu.writers import omecsv as jax_omecsv  # noqa: E402
from wsinsight_tpu.writers import wkt as jax_wkt  # noqa: E402
from wsinsight_tpu_torch.uri_path import URIPath  # noqa: E402
from wsinsight_tpu_torch.writers import geojson as port_geojson  # noqa: E402
from wsinsight_tpu_torch.writers import omecsv as port_omecsv  # noqa: E402
from wsinsight_tpu_torch.writers import wkt as port_wkt  # noqa: E402

PACKAGES = ("port", "jax")
UUID_RE = re.compile(rb'"id":"([0-9a-f-]{36})"')


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    monkeypatch.delenv("WSINSIGHT_PRECISION", raising=False)


def _fixed_stamps(monkeypatch):
    """uuid4 from a counter (reset by the returned function) and a fixed
    gzip mtime, for both packages' modules."""
    state = {"n": 0}

    def fake_uuid4():
        state["n"] += 1
        return uuid.UUID(int=state["n"], version=4)

    for mod in (port_geojson, jax_geojson):
        monkeypatch.setattr(mod.uuid, "uuid4", fake_uuid4)
    for mod in (port_omecsv, jax_omecsv):
        monkeypatch.setattr(mod._gzip, "time", types.SimpleNamespace(time=lambda: 1.7e9))

    def reset():
        state["n"] = 0

    return reset


def _tile_csv(path, seed):
    """A classifier's model-output CSV: a 350 px grid, two classes."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:12, 0:15] * 350
    n = xs.size
    p = rng.random(n)
    df = pd.DataFrame(dict(minx=xs.ravel(), miny=ys.ravel(), width=350, height=350,
                           prob_Other=1 - p, prob_Tumor=p))
    df.to_csv(path, index=False)


def _cell_csv(path, seed):
    """An end2end cell model's CSV: one row per nucleus (bboxes of 6-20 px),
    six classes."""
    rng = np.random.default_rng(seed)
    n = 400
    xy = rng.integers(0, 4000, (n, 2))
    wh = rng.integers(6, 21, (n, 2))
    p = rng.dirichlet(np.ones(6), n).astype(np.float32)
    df = pd.DataFrame(dict(minx=xy[:, 0], miny=xy[:, 1], width=wh[:, 0], height=wh[:, 1]))
    df.loc[:, [f"prob_class{i}" for i in range(6)]] = p
    df.to_csv(path, index=False)


def _write(package, writer, kind, src, out, workers):
    """One package's writer over both CSVs of ``src``."""
    uri = URIPath if package == "port" else JaxURIPath
    csvs = sorted(uri(str(p)) for p in src.glob("*.csv"))
    out.mkdir()
    results = uri(str(out))
    if writer == "geojson":
        mod = port_geojson if package == "port" else jax_geojson
        mod.write_geojsons(csvs=csvs, results_dir=results, overlap=0.25,
                           output_dir="model-outputs-geojson", prefix="prob",
                           num_workers=workers, object_type="tile" if kind == "tile" else "detection",
                           set_classification=kind == "cell", show_progress=False)
        return sorted((out / "model-outputs-geojson").iterdir())
    mod = port_omecsv if package == "port" else jax_omecsv
    mod.write_omecsvs(csvs=csvs, h5s=[], overlap=0.25, results_dir=results,
                      output_dir="model-outputs-omecsv", prefix="prob", num_workers=workers,
                      show_progress=False)
    return sorted((out / "model-outputs-omecsv").iterdir())


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("writer", ["geojson", "omecsv"])
@pytest.mark.parametrize("kind", ["tile", "cell"])
def test_writers_byte_identical_to_jax(tmp_path, monkeypatch, kind, writer, workers):
    reset = _fixed_stamps(monkeypatch)
    if workers:  # the pool as the host sized it for two workers, on any host
        for mod in (port_workers, jax_workers):
            monkeypatch.setattr(mod, "governed_workers", lambda n, max_workers=32: n)
    src = tmp_path / "csv"
    src.mkdir()
    for i, stem in enumerate(("slide_a", "slide_b")):
        (_tile_csv if kind == "tile" else _cell_csv)(src / f"{stem}.csv", i)
    files = {}
    for package in PACKAGES:
        reset()
        files[package] = _write(package, writer, kind, src, tmp_path / package, workers)
    names = [[p.name for p in files[k]] for k in PACKAGES]
    suffix = ".geojson" if writer == "geojson" else ".ome.csv.gz"
    assert names[0] == names[1] == [f"slide_a{suffix}", f"slide_b{suffix}"]
    rows = {p.stem: len(pd.read_csv(p)) for p in src.glob("*.csv")}
    for got, want in zip(files["port"], files["jax"]):
        a, b = got.read_bytes(), want.read_bytes()
        if writer == "geojson":
            feats = json.loads(a)["features"]
            assert len(feats) == rows[got.name[: -len(suffix)]]
            if workers:  # pooled: random ids, each a uuid4
                for blob in (a, b):
                    ids = UUID_RE.findall(blob)
                    assert len(ids) == len(feats)
                    assert all(uuid.UUID(i.decode()).version == 4 for i in ids)
                a, b = UUID_RE.sub(b'"id":""', a), UUID_RE.sub(b'"id":""', b)
            assert a == b, got.name
        else:
            text = gzip.decompress(a).decode()
            assert text.count("\n") == rows[got.name[: -len(suffix)]]
            if workers:  # pooled: the gzip mtime is the wall clock's
                assert gzip.decompress(a) == gzip.decompress(b) and a[:4] == b[:4]
                a, b = a[:4] + a[8:], b[:4] + b[8:]
            assert a == b, got.name


WKTS = [
    "POLYGON ((10 20, 30 20, 30 40, 10 40, 10 20))",
    "POLYGON ((0 0, 100 0, 100 100, 0 100, 0 0), (20 20, 40 20, 40 40, 20 40, 20 20))",
    "MULTIPOLYGON (((0 0, 5 0, 5 5, 0 5, 0 0)), ((10.5 10.25, 20 10.25, 20 20, 10.5 10.25)))",
    "POLYGON((1.5 2.5,3 2.5,3 4,1.5 2.5))",
]


@pytest.mark.parametrize("text", WKTS)
def test_wkt_matches_jax(text):
    kind, polys = port_wkt.parse_wkt(text)
    want_kind, want_polys = jax_wkt.parse_wkt(text)
    assert kind == want_kind
    assert [[r.tolist() for r in p] for p in polys] == [[r.tolist() for r in p] for p in want_polys]
    assert port_wkt.wkt_to_geojson_geometry(text) == jax_wkt.wkt_to_geojson_geometry(text)
    # round trip: what the writer emits parses back to the same rings
    again = (port_wkt.polygon_wkt(polys[0]) if kind == "POLYGON"
             else port_wkt.multipolygon_wkt(polys))
    assert again == (jax_wkt.polygon_wkt(want_polys[0]) if kind == "POLYGON"
                     else jax_wkt.multipolygon_wkt(want_polys))
    _, back = port_wkt.parse_wkt(again)
    for p, q in zip(back, polys):
        for r, s in zip(p, q):
            np.testing.assert_array_equal(r, s)


# --- QuPath inputs (after tests/test_qupath_modes.py's writers) ------------------


def _write_detection_tsv(path, mpp=0.25):
    """Detections, one of them of an unknown class, one with none, and one
    row that is not a detection (an annotation), which gets an all-zero
    row without shifting the others."""
    df = pd.DataFrame({
        "Object type": ["Detection", "Annotation", "Cell", "Detection", "Detection", "Cell"],
        "Name": ["Tumor cell", "Region", "Immune cell", "Tumor cell", "???", None],
        "Classification": ["Tumor", "Tumor", "Immune", "Tumor", "Necrosis", None],
        "Centroid X µm": np.array([100.0, 300.0, 500.0, 900.0, 1300.0, 1700.0]) * mpp,
        "Centroid Y µm": np.array([120.0, 320.0, 540.0, 960.0, 1200.0, 1500.0]) * mpp,
        "Parent": ["ROI", "Image", "ROI", "ROI 2", "ROI", "ROI 2"],
    })
    df.to_csv(path, sep="\t", index=False)


def _write_qupath_geojson(path, object_type):
    """Polygons (one a MultiPolygon), one of an unknown class, one without a
    class, a point feature (skipped), and a feature of the other object
    type (zero row)."""
    def feature(geom, name, otype=object_type):
        props = {"objectType": otype, "name": name}
        if name is not None:
            props["classification"] = {"name": name}
        return {"type": "Feature", "geometry": geom, "properties": props}

    def ring(cx, cy, r):
        return [[cx - r, cy - r], [cx + r, cy - r], [cx + r, cy + r], [cx - r, cy + r],
                [cx - r, cy - r]]

    other = "annotation" if object_type == "detection" else "detection"
    feats = [
        feature({"type": "Polygon", "coordinates": [ring(25.0, 30.0, 3)]}, "Tumor"),
        feature({"type": "MultiPolygon", "coordinates": [[ring(125.0, 135.0, 4)],
                                                          [ring(140.0, 150.0, 2)]]}, "Immune"),
        feature({"type": "Polygon", "coordinates": [ring(225.0, 235.5, 3)]}, "Stroma"),
        feature({"type": "Polygon", "coordinates": [ring(325.0, 335.0, 5)]}, None),
        feature({"type": "Point", "coordinates": [10.0, 10.0]}, "Tumor"),
        feature({"type": "Polygon", "coordinates": [ring(425.0, 435.0, 3)]}, "Tumor", other),
    ]
    path.write_text(json.dumps({"type": "FeatureCollection", "features": feats}))


def _ctx(package, slide_path, qdirs):
    if package == "port":
        from wsinsight_tpu_torch.patchlib.pipeline import _SlideContext
    else:
        from wsinsight_tpu.patchlib.pipeline import _SlideContext
    uri = URIPath if package == "port" else JaxURIPath
    opts = dict(patch_size_px=56, qupath_detection_dir=None, qupath_geojson_detection_dir=None)
    opts.update({k: uri(str(v)) for k, v in qdirs.items()})
    return _SlideContext(slide=None, slide_path=uri(str(slide_path)), mpp=0.25, patch_size=56,
                         polygon=None, opts=opts)


@pytest.mark.parametrize("mode", ["tsv", "geojson", "missing"])
def test_qupath_planners_match_jax(tmp_path, mode):
    """Modes 1 and 2 of the patch planner: identical coords and rings (the
    TSV ring is the patch's own extent; GeoJSON rings stay in the file's
    units, every part of a MultiPolygon kept); a slide without a detection
    file gets an empty plan."""
    from wsinsight_tpu.patchlib import pipeline as jax_pipeline
    from wsinsight_tpu_torch.patchlib import pipeline as port_pipeline

    qdir = tmp_path / "qp"
    qdir.mkdir()
    if mode == "geojson":
        _write_qupath_geojson(qdir / "slide.geojson", "detection")
        key, planner = "qupath_geojson_detection_dir", "_plan_qupath_geojson"
    else:
        if mode == "tsv":
            _write_detection_tsv(qdir / "slide.txt")
        key, planner = "qupath_detection_dir", "_plan_qupath_tsv"
    plans = {pkg: getattr(mod, planner)(_ctx(pkg, tmp_path / "slide.tif", {key: qdir}))
             for pkg, mod in (("port", port_pipeline), ("jax", jax_pipeline))}
    got, want = plans["port"], plans["jax"]
    assert got.patch_size == want.patch_size == 56
    assert got.coords.dtype == want.coords.dtype
    np.testing.assert_array_equal(got.coords, want.coords)
    if mode == "missing":
        assert got.coords.shape == (0, 2) and got.polygons is None is want.polygons
        return
    assert len(got.coords) == {"tsv": 6, "geojson": 5}[mode]
    assert len(got.polygons) == len(want.polygons) == {"tsv": 6, "geojson": 6}[mode]
    for r, s in zip(got.polygons, want.polygons):
        assert r.dtype == s.dtype == np.float32
        np.testing.assert_array_equal(r, s)
    if mode == "tsv":  # each ring is its own box, closed
        np.testing.assert_array_equal(got.polygons[0][0], got.coords[0])
        np.testing.assert_array_equal(got.polygons[0][2], got.coords[0] + 56)


def _patch_stage(package, slide, results, **qdirs):
    if package == "port":
        from wsinsight_tpu_torch.patchlib import segment_and_patch_one_slide
    else:
        from wsinsight_tpu.patchlib import segment_and_patch_one_slide
    uri = URIPath if package == "port" else JaxURIPath
    kw = dict(qupath_detection_dir=None, qupath_geojson_detection_dir=None,
              qupath_geojson_annotation_dir=None)
    kw.update({k: uri(str(v)) for k, v in qdirs.items()})
    segment_and_patch_one_slide(slide_path=uri(str(slide)), save_dir=uri(str(results)),
                                patch_size_px=56, patch_spacing_um_px=0.25, object_based=True,
                                **kw)


def test_qupath_patch_stage_matches_jax(purple_slide, tmp_path):
    """The patch stage in QuPath TSV mode: identical patch files."""
    import h5py

    qdir = tmp_path / "qp"
    qdir.mkdir()
    _write_detection_tsv(qdir / "purple.txt")
    for package in PACKAGES:
        _patch_stage(package, purple_slide, tmp_path / package, qupath_detection_dir=qdir)
    with h5py.File(tmp_path / "port" / "patches" / "purple.h5", "r") as p, \
            h5py.File(tmp_path / "jax" / "patches" / "purple.h5", "r") as j:
        for name in ("/coords", "/polygons/coords", "/polygons/offsets"):
            np.testing.assert_array_equal(p[name][()], j[name][()], err_msg=name)
        assert len(p["/coords"]) == 6
        for group in ("/coords", "/slide"):
            assert dict(p[group].attrs).keys() == dict(j[group].attrs).keys()


def _pseudo_model(package, names, architecture, object_based=True):
    if package == "port":
        from wsinsight_tpu_torch.zoo import ModelConfiguration, ModelHandle
    else:
        from wsinsight_tpu.zoo import ModelConfiguration, ModelHandle
    cfg = ModelConfiguration(architecture=architecture, num_classes=len(names),
                             class_names=list(names), patch_size_pixels=56, spacing_um_px=0.25,
                             transform=[])
    return ModelHandle(name=architecture, config=cfg)


def _minimal_patch_file(package, results, slide):
    if package == "port":
        from wsinsight_tpu_torch.patchlib.io import save_hdf5
    else:
        from wsinsight_tpu.patchlib.io import save_hdf5
    (results / "patches").mkdir(parents=True)
    save_hdf5(path=results / "patches" / "purple.h5", coords=np.array([[0, 0]], np.int32),
              polygons=None, tile_dim=None, patch_size=56, patch_spacing_um_px=0.25,
              slide_path=str(slide), slide_mpp=0.25, slide_width=4096, slide_height=4096)


@pytest.fixture
def no_device(monkeypatch):
    """The QuPath branches build no engine and resolve no device."""
    from wsinsight_tpu_torch.engine import runner

    def refuse(*args, **kwargs):
        raise AssertionError("a QuPath pseudo-model touched the engine or the device")

    for name in ("resolve_device", "ClassifierEngine"):
        monkeypatch.setattr(runner, name, refuse)


def _run_inference(package, results, model, **kwargs):
    if package == "port":
        from wsinsight_tpu_torch.engine import run_inference
    else:
        from wsinsight_tpu.engine import run_inference
    uri = URIPath if package == "port" else JaxURIPath
    kwargs = {k: uri(str(v)) if k.endswith("_dir") and v is not None else v
              for k, v in kwargs.items()}
    return run_inference(wsi_dir=None, slide_paths=None, results_dir=uri(str(results)),
                         model_info=model, **kwargs)


@pytest.mark.parametrize("mode", ["tsv", "geojson", "annotation"])
def test_run_inference_qupath_matches_jax(purple_slide, tmp_path, no_device, mode):
    """Each QuPath pseudo-model: identical CSVs, row-aligned one-hot rows
    (all-zero for unknown classes and other object types), the TSV's
    qupath_detection_parent column."""
    qdir = tmp_path / "qp"
    qdir.mkdir()
    names = ["tumor", "immune"]
    if mode == "tsv":
        _write_detection_tsv(qdir / "purple.txt")
        kwargs = dict(qupath_detection_dir=qdir, object_based=True)
        arch = "qupath.detection"
    else:
        _write_qupath_geojson(qdir / "purple.geojson",
                              "detection" if mode == "geojson" else "annotation")
        key = f"qupath_geojson_{'detection' if mode == 'geojson' else 'annotation'}_dir"
        kwargs = {key: qdir, "object_based": mode == "geojson"}
        arch = "qupath.geojson"
    csvs = {}
    for package in PACKAGES:
        results = tmp_path / package
        if mode == "tsv":
            _patch_stage(package, purple_slide, results, qupath_detection_dir=qdir)
        else:
            _minimal_patch_file(package, results, purple_slide)
        failed = _run_inference(package, results, _pseudo_model(package, names, arch), **kwargs)
        assert failed == ([], [])
        csvs[package] = (results / "model-outputs-csv" / "purple.csv").read_text()
    assert csvs["port"] == csvs["jax"]
    df = pd.read_csv(tmp_path / "port" / "model-outputs-csv" / "purple.csv")
    probs = df[["prob_tumor", "prob_immune"]].to_numpy()
    if mode == "tsv":
        assert list(df.columns)[-1] == "qupath_detection_parent"
        assert df["qupath_detection_parent"].tolist() == ["ROI", "Image", "ROI", "ROI 2", "ROI",
                                                          "ROI 2"]
        np.testing.assert_array_equal(probs, [[1, 0], [0, 0], [0, 1], [1, 0], [0, 0], [0, 0]])
    else:
        assert len(df) == 5  # the point feature has no row
        np.testing.assert_array_equal(probs, [[1, 0], [0, 1], [0, 0], [0, 0], [0, 0]])


def test_run_inference_qupath_missing_file_is_listed(purple_slide, tmp_path, no_device):
    """A slide without its QuPath file fails in both packages, and gets no CSV."""
    qdir = tmp_path / "qp"
    qdir.mkdir()
    for package in PACKAGES:
        results = tmp_path / package
        _minimal_patch_file(package, results, purple_slide)
        failed = _run_inference(package, results,
                                _pseudo_model(package, ["tumor"], "qupath.geojson"),
                                qupath_geojson_detection_dir=qdir, object_based=True)
        assert failed == ([], ["purple"])
        assert not (results / "model-outputs-csv" / "purple.csv").exists()


def test_references_overlay_matches_jax(purple_slide, tmp_path, no_device):
    """The references overlay on a TSV pseudo-model's rows: identical CSVs
    with annot_prob_* filled from the prior run's tiles (the largest box that
    holds a row's centre), NaN where none does."""
    qdir = tmp_path / "qp"
    qdir.mkdir()
    _write_detection_tsv(qdir / "purple.txt")
    refs = tmp_path / "refs"
    (refs / "model-outputs-csv").mkdir(parents=True)
    # two overlapping tiles cover the first detections; the last ones lie outside
    pd.DataFrame(dict(minx=[0, 0], miny=[0, 0], width=[700, 300], height=[700, 300],
                      prob_Other=[0.25, 0.875], prob_Tumor=[0.75, 0.125])).to_csv(
        refs / "model-outputs-csv" / "purple.csv", index=False)
    csvs = {}
    for package in PACKAGES:
        results = tmp_path / package
        _patch_stage(package, purple_slide, results, qupath_detection_dir=qdir)
        failed = _run_inference(package, results,
                                _pseudo_model(package, ["tumor", "immune"], "qupath.detection"),
                                qupath_detection_dir=qdir, object_based=True, references_dir=refs)
        assert failed == ([], [])
        csvs[package] = (results / "model-outputs-csv" / "purple.csv").read_text()
    assert csvs["port"] == csvs["jax"]
    df = pd.read_csv(tmp_path / "port" / "model-outputs-csv" / "purple.csv")
    assert list(df.columns)[-2:] == ["annot_prob_prob_Other", "annot_prob_prob_Tumor"]
    got = df["annot_prob_prob_Tumor"].to_numpy()
    np.testing.assert_array_equal(got[:3], [0.75, 0.75, 0.75])
    assert np.isnan(got[3:]).all()


# --- the CLI ---------------------------------------------------------------------


def _cli(package):
    if package == "port":
        from wsinsight_tpu_torch.cli.cli import cli
    else:
        from wsinsight_tpu.cli.cli import cli
    return cli


@pytest.mark.parametrize("mode", ["tsv", "annotation"])
def test_cli_qupath_run_with_exports_matches_jax(purple_slide, tmp_path, monkeypatch, no_device,
                                                 mode):
    """`run` with a QuPath directory and --geojson --omecsv through both
    CLIs: the pseudo-model from the QuPath classes, identical CSVs and
    byte-identical exports (detections for TSV, tiles for annotations)."""
    from click.testing import CliRunner

    reset = _fixed_stamps(monkeypatch)
    qdir = tmp_path / "qp"
    qdir.mkdir()
    if mode == "tsv":
        _write_detection_tsv(qdir / "purple.txt")
        qopt = ["--qupath-detection-dir", str(qdir)]
    else:
        _write_qupath_geojson(qdir / "purple.geojson", "annotation")
        qopt = ["--qupath-geojson-annotation-dir", str(qdir)]
    for package in PACKAGES:
        reset()
        res = CliRunner().invoke(
            _cli(package), ["run", "-i", str(purple_slide.parent), "-o", str(tmp_path / package),
                            *qopt, "--geojson", "--omecsv", "--export-workers", "1"],
            catch_exceptions=False)
        assert res.exit_code == 0, res.output
    outs = ["model-outputs-csv/purple.csv", "model-outputs-geojson/purple.geojson",
            "model-outputs-omecsv/purple.ome.csv.gz"]
    for out in outs:
        assert (tmp_path / "port" / out).read_bytes() == (tmp_path / "jax" / out).read_bytes(), out
    feats = json.loads((tmp_path / "port" / outs[1]).read_text())["features"]
    csv = pd.read_csv(tmp_path / "port" / outs[0])
    assert len(feats) == len(csv) and len(csv) > 0
    props = feats[0]["properties"]
    assert props["objectType"] == ("detection" if mode == "tsv" else "tile")
    assert ("classification" in props) == (mode == "tsv")
    # the pseudo-model's classes are the union of the file's, normalized
    want = ["immune", "necrosis", "tumor"] if mode == "tsv" else ["immune", "stroma", "tumor"]
    assert [c for c in csv.columns if c.startswith("prob_")] == [f"prob_{c}" for c in want]


def test_qupath_project_without_paquo_fails_as_jax(purple_slide, tmp_path):
    """--qupath needs paquo and QuPath; without them both CLIs stop after the
    stages with the same error (SystemExit, exit code 1)."""
    from click.testing import CliRunner

    import wsinsight_tpu.writers.qupath as jax_qupath
    import wsinsight_tpu_torch.writers.qupath as port_qupath

    assert port_qupath.HAS_PAQUO == jax_qupath.HAS_PAQUO
    if port_qupath.HAS_PAQUO:
        pytest.skip("paquo is installed here")
    qdir = tmp_path / "qp"
    qdir.mkdir()
    _write_detection_tsv(qdir / "purple.txt")
    results = {}
    for package in PACKAGES:
        res = CliRunner().invoke(
            _cli(package), ["run", "-i", str(purple_slide.parent), "-o", str(tmp_path / package),
                            "--qupath-detection-dir", str(qdir), "--qupath"])
        results[package] = res
        assert (tmp_path / package / "model-outputs-csv" / "purple.csv").exists()
    assert type(results["port"].exception) is type(results["jax"].exception) is SystemExit
    assert results["port"].exit_code == results["jax"].exit_code == 1
    assert "QuPath was not found" in results["port"].output
    for mod in (port_qupath, jax_qupath):
        with pytest.raises(SystemExit):
            mod.make_qupath_project(None, tmp_path / "port")


def test_tosbu_matches_jax(purple_slide, tmp_path, monkeypatch):
    """`tosbu` (not registered on the CLI group, in either package) over the
    same results: byte-identical trees, with time and random fixed."""
    from click.testing import CliRunner

    from wsinsight_tpu.cli import convert_csv_to_sbubmi as jax_sbu
    from wsinsight_tpu_torch.cli import convert_csv_to_sbubmi as port_sbu
    from wsinsight_tpu_torch.cli.cli import cli

    assert "tosbu" not in cli.commands
    results = tmp_path / "results"
    (results / "model-outputs-csv").mkdir(parents=True)
    _tile_csv(results / "model-outputs-csv" / "purple.csv", 3)
    df = pd.read_csv(results / "model-outputs-csv" / "purple.csv")
    df[(df.minx < 3700) & (df.miny < 3700)].to_csv(results / "model-outputs-csv" / "purple.csv",
                                                  index=False)
    meta = {"timestamp": "2026-01-02T03:04:05", "runtime": {"git": {"commit": "abc"}},
            "model_config": {"class_names": ["Other", "Tumor", "notumor"]},
            "model_weights": {"weights_file": "w.pt", "weights_sha256": "0" * 64}}
    (results / "run_metadata_20260102T030405.json").write_text(json.dumps(meta))
    for mod in (port_sbu, jax_sbu):
        monkeypatch.setattr(mod.time, "time", lambda: 1.7e9)
        monkeypatch.setattr(mod.random, "uniform", lambda a, b: 0.5)
    for package, mod in (("port", port_sbu), ("jax", jax_sbu)):
        res = CliRunner().invoke(mod.tosbu, [str(results), str(tmp_path / package), "--wsi-dir",
                                             str(purple_slide.parent), "--execution-id", "run1",
                                             "--study-id", "TCGA-BRCA", "--make-color-text"],
                                 catch_exceptions=False)
        assert res.exit_code == 0, res.output
    files = {pkg: sorted(p.relative_to(tmp_path / pkg) for p in (tmp_path / pkg).rglob("*")
                         if p.is_file()) for pkg in PACKAGES}
    assert files["port"] == files["jax"] and len(files["port"]) == 8  # per class: 2 JSON, 2 text
    for rel in files["port"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
