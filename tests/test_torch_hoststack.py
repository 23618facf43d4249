"""The port's host stack, module by module, against the JAX package.

The same inputs, made from a numpy seed, go through each JAX module and its
copy in the port: tissue segmentation, the patch grid, the TIFF writer and
reader, the patch file, ``PatchBatchSource`` (with its input options) and
``plan_slide``. Then `run`'s analytics options against the JAX CLI's, and
the options the port refuses, each naming the ROADMAP.md item it waits for.

Both readers decode regions with their native (C++) reader, the same source
in each package, so JPEG pages too must agree byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    for var in ("WSINSIGHT_WIRE", "WSINSIGHT_HOST_RESIZE", "WSINSIGHT_DECODE_SCALE",
                "WSINSIGHT_PRECISION", "WSINSIGHT_PROFILE", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)


def _tissue_image(side: int, seed: int) -> np.ndarray:
    """H&E-toned ellipses, one with a hole, on near-white glass, with noise."""
    rng = np.random.default_rng(seed)
    img = np.full((side, side, 3), 236, np.int16)
    yy, xx = np.mgrid[:side, :side]
    for tone in ((176, 98, 168), (214, 132, 186), (150, 80, 160)):
        cy, cx = rng.uniform(0.25, 0.75, 2) * side
        ry, rx = rng.uniform(0.1, 0.25, 2) * side
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = tone
    img[((yy - side / 2) / (0.04 * side)) ** 2 + ((xx - side / 2) / (0.04 * side)) ** 2 <= 1] = 236
    img += rng.integers(-3, 4, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    """{compression: path} of one 2048 px tissue slide at 0.25 um/px, 3
    levels, written by the port's writer."""
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    d = tmp_path_factory.mktemp("hostslides")
    img = _tissue_image(2048, seed=3)
    out = {}
    for comp in ("deflate", "jpeg"):
        out[comp] = d / f"tissue_{comp}.tif"
        write_pyramidal_tiff(str(out[comp]), img, tile=(256, 256), compression=comp,
                             mpp=0.25, levels=3)
    return out


@pytest.mark.parametrize("seed,params", [
    (0, {}),
    (1, dict(median_filter_size=5, binary_threshold=12, closing_kernel_size=4,
             min_object_size_px=200, min_hole_size_px=50)),
    (2, dict(min_object_size_px=0, min_hole_size_px=0)),
])
def test_segment_tissue_matches_jax(seed, params):
    from wsinsight_tpu.patchlib import segment_tissue as jax_segment
    from wsinsight_tpu_torch.patchlib import segment_tissue

    img = _tissue_image(384, seed)
    got = segment_tissue(img, **params)
    want = jax_segment(img, **params)
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("overlap", [0.0, 0.5, -0.25])
def test_patch_grid_matches_jax(overlap):
    """Contours, containment and the grid of centroids strictly inside."""
    from wsinsight_tpu import patchlib as jax_patchlib
    from wsinsight_tpu_torch import patchlib

    mask = jax_patchlib.segment_tissue(_tissue_image(512, 5), min_object_size_px=100,
                                       min_hole_size_px=10).astype(np.uint8) * 255
    scale = (8000 / 512, 6000 / 512)
    poly, contours, hier = patchlib.get_multipolygon_from_binary_arr(mask, scale=scale)
    j_poly, j_contours, j_hier = jax_patchlib.get_multipolygon_from_binary_arr(mask, scale=scale)
    np.testing.assert_array_equal(hier, j_hier)
    assert len(contours) == len(j_contours) > 1
    for a, b in zip(contours, j_contours):
        np.testing.assert_array_equal(a, b)
    got = patchlib.get_patch_coordinates_within_polygon(8000, 6000, 350, 175, poly, overlap)
    want = jax_patchlib.get_patch_coordinates_within_polygon(8000, 6000, 350, 175, j_poly,
                                                             overlap)
    assert got.dtype == want.dtype and len(got) > 10
    np.testing.assert_array_equal(got, want)
    pts = np.random.default_rng(1).uniform(0, 8000, (500, 2))
    np.testing.assert_array_equal(poly.contains_points(pts), j_poly.contains_points(pts))


@pytest.mark.parametrize("compression", ["deflate", "jpeg", "none"])
def test_writer_bytes_match_jax(tmp_path, compression):
    from wsinsight_tpu.wsi.tiff import write_pyramidal_tiff as jax_write
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    img = _tissue_image(700, 4)  # tiles cross the image edge
    write_pyramidal_tiff(str(tmp_path / "port.tif"), img, tile=(256, 256),
                         compression=compression, mpp=0.5, levels=2, description="d")
    jax_write(str(tmp_path / "jax.tif"), img, tile=(256, 256), compression=compression,
              mpp=0.5, levels=2, description="d")
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()


REGIONS = [  # (x, y, w, h) in level-0 px; the last three leave the slide
    (0, 0, 350, 350), (300, 700, 350, 350), (1700, 1700, 348, 348), (-100, 50, 300, 200),
    (1900, 1990, 350, 350), (5000, 5000, 64, 64),
]


@pytest.mark.parametrize("compression", ["deflate", "jpeg"])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_reader_matches_jax(slides, compression, level):
    from wsinsight_tpu.wsi.slide import TpuSlide as JaxSlide
    from wsinsight_tpu_torch.wsi.slide import TpuSlide

    path = str(slides[compression])
    with TpuSlide(path) as s, JaxSlide(path) as j:
        assert s.level_dimensions == j.level_dimensions
        assert s.level_downsamples == j.level_downsamples
        assert s.properties == j.properties
        assert s.has_native(level)
        for x, y, w, h in REGIONS:
            got = s.read_region_array((x, y), level, (w, h))
            np.testing.assert_array_equal(got, j.read_region_array((x, y), level, (w, h)))
            img = s.read_region((x, y), level, (w, h))
            assert img.size == (w, h) and img.mode == "RGB"
        thumb = np.asarray(s.get_thumbnail((300 * (level + 1), 200 * (level + 1))))
        want = np.asarray(j.get_thumbnail((300 * (level + 1), 200 * (level + 1))))
        np.testing.assert_array_equal(thumb, want)
        # each region twice (array and PIL); the last lies wholly outside
        assert s.reads == {"native": 2 * (len(REGIONS) - 1), "python": 0}


def test_avg_mpp_and_directory_checks(slides, tmp_path):
    from wsinsight_tpu.wsi import get_avg_mpp as jax_mpp
    from wsinsight_tpu_torch.errors import DuplicateFilePrefixesFound
    from wsinsight_tpu_torch.wsi import _validate_wsi_directory, get_avg_mpp

    for path in slides.values():
        assert get_avg_mpp(path) == jax_mpp(path) == pytest.approx(0.25)
    (tmp_path / "a.tif").write_bytes(b"")
    (tmp_path / "a.svs").write_bytes(b"")
    with pytest.raises(DuplicateFilePrefixesFound):
        _validate_wsi_directory(tmp_path)


def _plan(slide_path):
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath

    plan, ctx, thumb, contours, hierarchy = plan_slide(
        URIPath(str(slide_path)), None, None, None, 350, 0.25, thumbsize=(1024, 1024),
        min_object_size_um2=50**2, min_hole_size_um2=10**2,
    )
    ctx.slide.close()
    return plan


@pytest.fixture(scope="module")
def patch_files(slides, tmp_path_factory):
    """The deflate slide's patch files: {package: results dir}, written by
    each package's segment_and_patch_one_slide (with the /images cache)."""
    from wsinsight_tpu.patchlib import segment_and_patch_one_slide as jax_patch
    from wsinsight_tpu.uri_path import URIPath as JaxURIPath
    from wsinsight_tpu_torch.patchlib import segment_and_patch_one_slide
    from wsinsight_tpu_torch.uri_path import URIPath

    out = tmp_path_factory.mktemp("patchfiles")
    opts = dict(qupath_detection_dir=None, qupath_geojson_detection_dir=None,
                qupath_geojson_annotation_dir=None, patch_size_px=350,
                patch_spacing_um_px=0.25, thumbsize=(1024, 1024),
                min_object_size_um2=50**2, min_hole_size_um2=10**2,
                cache_image_patches=True)
    segment_and_patch_one_slide(slide_path=URIPath(str(slides["deflate"])),
                                save_dir=URIPath(str(out / "port")), **opts)
    jax_patch(slide_path=JaxURIPath(str(slides["deflate"])), save_dir=JaxURIPath(str(out / "jax")),
              **opts)
    return {"port": out / "port", "jax": out / "jax"}


def test_plan_slide_matches_patch_files(slides, patch_files):
    """plan_slide (in memory) gives the coords both packages' patch stages
    write; the patch files match attr for attr, /images and /polygons too."""
    import h5py

    plan = _plan(slides["deflate"])
    assert plan.patch_size == 350 and len(plan.coords) > 5
    files = [h5py.File(patch_files[k] / "patches" / "tissue_deflate.h5", "r")
             for k in ("port", "jax")]
    try:
        port, jax = files
        np.testing.assert_array_equal(port["/coords"][()], plan.coords)
        np.testing.assert_array_equal(port["/coords"][()], jax["/coords"][()])
        for group in ("/coords", "/slide"):
            assert dict(port[group].attrs).keys() == dict(jax[group].attrs).keys()
            for k, v in port[group].attrs.items():
                np.testing.assert_array_equal(v, jax[group].attrs[k])
        np.testing.assert_array_equal(port["/coords"].attrs["tile_dim"], plan.tile_dim)
        for name in ("/images", "/polygons/coords", "/polygons/offsets"):
            np.testing.assert_array_equal(port[name][()], jax[name][()])
    finally:
        for f in files:
            f.close()
    for k in ("port", "jax"):
        assert (patch_files[k] / "masks" / "tissue_deflate.jpg").exists()


def _batches(src):
    try:
        return list(src)
    finally:
        src.close()


@pytest.mark.parametrize("use_images", [False, True])
@pytest.mark.parametrize("batch_size,threads", [(4, 1), (5, 3)])
def test_patch_batch_source_matches_jax(slides, patch_files, use_images, batch_size, threads):
    """The port's HDF5 source, its from_coords source and the JAX source give
    the same batches: images (zero past n_valid), coords and n_valid."""
    from wsinsight_tpu.engine.data import PatchBatchSource as JaxSource
    from wsinsight_tpu_torch.engine.data import PatchBatchSource, read_patch_coords

    h5 = patch_files["port"] / "patches" / "tissue_deflate.h5"
    coords, tile_dim, ps = read_patch_coords(h5)
    kw = dict(batch_size=batch_size, num_threads=threads)
    runs = {
        "hdf5": _batches(PatchBatchSource(str(slides["deflate"]), h5, use_images, **kw)),
        "from_coords": _batches(PatchBatchSource.from_coords(
            str(slides["deflate"]), coords[:, :2], ps, tile_dim=tile_dim, **kw)),
        "jax": _batches(JaxSource(str(slides["deflate"]), h5, use_images, **kw)),
    }
    n = len(coords)
    for name, batches in runs.items():
        assert len(batches) == -(-n // batch_size), name
        assert sum(b.n_valid for b in batches) == n
        for b in batches:
            assert b.images.shape == (batch_size, ps, ps, 3) and b.images.dtype == np.uint8
            assert not b.images[b.n_valid:].any() and not b.coords[b.n_valid:].any()
    for name in ("from_coords", "jax"):
        for a, b in zip(runs["hdf5"], runs[name]):
            assert a.n_valid == b.n_valid
            np.testing.assert_array_equal(a.coords, b.coords, err_msg=name)
            np.testing.assert_array_equal(a.images, b.images, err_msg=name)
    assert np.concatenate([b.coords[:b.n_valid] for b in runs["hdf5"]]).tolist() == coords.tolist()


def test_source_order_options_match_jax(slides, patch_files):
    from wsinsight_tpu.engine.data import PatchBatchSource as JaxSource
    from wsinsight_tpu_torch.engine.data import PatchBatchSource

    h5 = patch_files["port"] / "patches" / "tissue_deflate.h5"
    for kw in (dict(shuffle_seed=7), dict(order_by_y=True)):
        got = _batches(PatchBatchSource(str(slides["deflate"]), h5, False, batch_size=8, **kw))
        want = _batches(JaxSource(str(slides["deflate"]), h5, False, batch_size=8, **kw))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.coords, b.coords)
            np.testing.assert_array_equal(a.images, b.images)


def test_device_prefetch_puts_ahead(slides):
    """device_prefetch hands each batch to `put` before the consumer takes it."""
    from wsinsight_tpu_torch.engine.data import PatchBatchSource

    plan = _plan(slides["deflate"])
    src = PatchBatchSource.from_coords(str(slides["deflate"]), plan.coords, 350, batch_size=4)
    put_order = []

    def put(images):
        put_order.append(len(put_order))
        return torch.from_numpy(images)

    try:
        for i, b in enumerate(src.device_prefetch(put, depth=2)):
            assert isinstance(b.images, torch.Tensor)
            assert len(put_order) == min(i + 3, src.num_batches)
    finally:
        src.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_hdf5_read_patch_coords_roundtrip(tmp_path, writer):
    from wsinsight_tpu.engine.data import read_patch_coords as jax_read
    from wsinsight_tpu.patchlib import save_hdf5 as jax_save
    from wsinsight_tpu_torch.engine.data import read_patch_coords
    from wsinsight_tpu_torch.patchlib import save_hdf5

    rng = np.random.default_rng(0)
    coords = rng.integers(0, 10_000, (37, 2))
    save = save_hdf5 if writer == "port" else jax_save
    save(tmp_path / "p.h5", coords, None, np.array([12, 9]), 350, 0.25,
         slide_path="/slides/x.svs", slide_mpp=0.25, slide_width=9000, slide_height=8000)
    got, want = read_patch_coords(tmp_path / "p.h5"), jax_read(tmp_path / "p.h5")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], np.concatenate([coords, np.full_like(coords, 350)], 1))
    np.testing.assert_array_equal(got[1], [12, 9])
    assert got[2] == want[2] == 350


def test_read_patch_coords_rejects_bad_files(tmp_path):
    import h5py

    from wsinsight_tpu_torch.engine.data import read_patch_coords

    with h5py.File(tmp_path / "nolevel.h5", "w") as f:
        f.create_dataset("/coords", data=np.zeros((3, 2), np.int32)).attrs["patch_size"] = 10
    with pytest.raises(KeyError, match="patch_level"):
        read_patch_coords(tmp_path / "nolevel.h5")
    with h5py.File(tmp_path / "level1.h5", "w") as f:
        ds = f.create_dataset("/coords", data=np.zeros((3, 2), np.int32))
        ds.attrs.update(patch_size=10, patch_level=1)
    with pytest.raises(NotImplementedError):
        read_patch_coords(tmp_path / "level1.h5")


# ---------------------------------------------------------------------------
# What the port refuses, and says so
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression,kwargs,image_hw,shape", [
    ("deflate", dict(host_resize=(224, 224)), (224, 224), (224, 224, 3)),
    ("deflate", dict(wire="yuv420"), (350, 350), (525, 350)),
    ("jpeg", dict(wire="yuv420", decode_scale=2), (176, 176), (264, 176)),
])
def test_source_input_options_match_jax(slides, compression, kwargs, image_hw, shape):
    """Host resize, the YUV 4:2:0 wire and the DCT half decode: the port's
    source gives the JAX source's batches byte for byte (both decode with
    their native reader and resize and pack with the same C++), through the
    native whole-batch path (no Python reads)."""
    from wsinsight_tpu.engine.data import PatchBatchSource as JaxSource
    from wsinsight_tpu.patchlib import segment_and_patch_one_slide as jax_patch
    from wsinsight_tpu.uri_path import URIPath as JaxURIPath
    from wsinsight_tpu_torch.engine.data import PatchBatchSource, read_patch_coords

    plan = _plan(slides[compression])
    src = PatchBatchSource.from_coords(str(slides[compression]), plan.coords, 350,
                                       batch_size=8, num_threads=3, **kwargs)
    assert src.image_hw == image_hw
    assert src.decode_scale == kwargs.get("decode_scale", 1)
    assert src.wire == kwargs.get("wire")
    reads = src._slide.reads
    got = _batches(src)
    assert reads["python"] == 0 and reads["native"] >= len(plan.coords)

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        jax_patch(slide_path=JaxURIPath(str(slides[compression])), save_dir=JaxURIPath(d),
                  qupath_detection_dir=None, qupath_geojson_detection_dir=None,
                  qupath_geojson_annotation_dir=None, patch_size_px=350,
                  patch_spacing_um_px=0.25, thumbsize=(1024, 1024),
                  min_object_size_um2=50**2, min_hole_size_um2=10**2)
        h5 = f"{d}/patches/tissue_{compression}.h5"
        np.testing.assert_array_equal(read_patch_coords(h5)[0][:, :2], plan.coords)
        want = _batches(JaxSource(str(slides[compression]), h5, False, batch_size=8,
                                  num_threads=3, **kwargs))
    assert len(got) == len(want) == -(-len(plan.coords) // 8)
    for a, b in zip(got, want):
        assert a.images.shape == b.images.shape == (8, *shape)
        assert a.n_valid == b.n_valid
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.images, b.images)


@pytest.mark.parametrize("patch_px,halo,step", [(256, 46, 164), (128, 16, 96)])
def test_plan_slide_halo_grid_matches_jax(slides, tmp_path, patch_px, halo, step):
    """End2end cell models plan the halo grid: overlap 2*halo/patch, so the
    step is patch - 2*halo; the same /coords, tile_dim and attrs as the JAX
    package's patch stage, and no polygons."""
    import h5py

    from wsinsight_tpu.patchlib import segment_and_patch_one_slide as jax_patch
    from wsinsight_tpu.uri_path import URIPath as JaxURIPath
    from wsinsight_tpu_torch.patchlib import plan_slide, segment_and_patch_one_slide
    from wsinsight_tpu_torch.uri_path import URIPath

    opts = dict(qupath_detection_dir=None, qupath_geojson_detection_dir=None,
                qupath_geojson_annotation_dir=None, patch_size_px=patch_px,
                patch_spacing_um_px=0.25, halo_size_px=halo, thumbsize=(1024, 1024),
                min_object_size_um2=50**2, min_hole_size_um2=10**2, object_based=True,
                object_detection="end2end")
    plan, ctx, *_ = plan_slide(URIPath(str(slides["deflate"])), **opts)
    ctx.slide.close()
    assert plan.polygons is None and plan.patch_size == patch_px and len(plan.coords) > 20
    steps = np.diff(np.unique(plan.coords[:, 0]))
    assert steps.min() == step
    segment_and_patch_one_slide(URIPath(str(slides["deflate"])), URIPath(str(tmp_path / "p")),
                                **opts)
    jax_patch(slide_path=JaxURIPath(str(slides["deflate"])), save_dir=JaxURIPath(str(tmp_path / "j")),
              **opts)
    with h5py.File(tmp_path / "p" / "patches" / "tissue_deflate.h5", "r") as port, \
            h5py.File(tmp_path / "j" / "patches" / "tissue_deflate.h5", "r") as jax:
        np.testing.assert_array_equal(port["/coords"][()], plan.coords)
        np.testing.assert_array_equal(port["/coords"][()], jax["/coords"][()])
        np.testing.assert_array_equal(port["/coords"].attrs["tile_dim"], plan.tile_dim)
        for group in ("/coords", "/slide"):
            assert dict(port[group].attrs).keys() == dict(jax[group].attrs).keys()
            for k, v in port[group].attrs.items():
                np.testing.assert_array_equal(v, jax[group].attrs[k])
        assert "/polygons" not in port and "/polygons" not in jax


def test_profile_env_raises(monkeypatch, tmp_path):
    """WSINSIGHT_PROFILE=<dir> no longer raises: maybe_trace times the stage
    and writes a torch.profiler trace of it under <dir>/<stage>/, where the
    JAX package writes its jax.profiler trace; unset, it only times."""
    import json

    from wsinsight_tpu_torch.utils.profiling import maybe_trace, stage_timings

    with maybe_trace("stage_x"):
        pass
    assert "stage_x" in stage_timings()
    monkeypatch.setenv("WSINSIGHT_PROFILE", str(tmp_path / "profile"))
    with maybe_trace("stage_y"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert "stage_y" in stage_timings()
    assert [p.name for p in (tmp_path / "profile").iterdir()] == ["stage_y"]
    (trace,) = (tmp_path / "profile" / "stage_y").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


def _typed_cells(n=20, step=10.0, radius=55.0):
    """A model-output CSV's cells on a grid (px): a tumour disk, an immune
    ring around it, other cells outside."""
    import pandas as pd

    xs, ys = np.meshgrid(np.arange(n) * step + 200, np.arange(n) * step + 200)
    cx, cy = xs.ravel(), ys.ravel()
    d = np.hypot(cx - cx.mean(), cy - cy.mean())
    tumor, immune = d < radius, (d >= radius) & (d < radius + 40)
    p_t, p_i = np.where(tumor, 0.9, 0.05), np.where(immune, 0.9, 0.05)
    return pd.DataFrame({"minx": cx - 4, "miny": cy - 4, "width": 8, "height": 8,
                         "prob_tumor": p_t, "prob_immune": p_i,
                         "prob_other": 1.0 - np.maximum(p_t, p_i)})


@pytest.fixture(scope="module")
def analytics_runs(slides, tmp_path_factory):
    """(port results, JAX results) of each CLI's `run --hplot ...
    --cme-cellular --cme-annotation --geojson --omecsv` over the deflate
    slide, with a seeded local classifier whose classes are the cells'
    types. The model-output CSV is written first (the typed cells), so
    inference skips the slide and the analytics and their exports run on it.
    Both runs' DGI embeddings are the slide graph's z-scored features beside
    seeded noise, which breaks the ties between cells of one composition
    (the training is held to the JAX package's in test_torch_insightlib.py)."""
    import shutil

    from click.testing import CliRunner

    import wsinsight_tpu.insightlib.cme as jax_cme
    import wsinsight_tpu_torch.insightlib.cme as port_cme
    from wsinsight_tpu.cli.cli import cli as jax_cli
    from wsinsight_tpu.zoo import make_random_local_model
    from wsinsight_tpu_torch.cli.cli import cli as port_cli

    out = tmp_path_factory.mktemp("analytics_runs")
    (out / "slides").mkdir()
    shutil.copy(slides["deflate"], out / "slides")
    cfg, weights = make_random_local_model("resnet34", 3, out / "model", resize_size=64,
                                           class_names=["tumor", "immune", "other"])
    args = ["run", "-i", str(out / "slides"), "--config", str(cfg), "--model-path",
            str(weights), "--hplot", "--hplot-base-types", "tumor", "--hplot-target-types",
            "immune", "--cme-cellular", "--cme-annotation", "--geojson", "--omecsv", "-n", "1",
            "--export-workers", "1"]
    z_lists = []

    def embeddings(slides, **kw):
        rng = np.random.default_rng(0)
        z_lists.append([np.hstack([s["X_normalized"], rng.normal(0, 0.5, (len(s["X"]), 8))])
                        .astype(np.float32) for s in slides])
        return None, z_lists[-1]

    mp = pytest.MonkeyPatch()
    mp.setenv("WSINFER_FORCE_CPU", "1")
    mp.setattr(jax_cme, "train_dgi_multi", embeddings)
    mp.setattr(port_cme, "train_dgi_multi", embeddings)
    try:
        for name, cli in (("jax", jax_cli), ("port", port_cli)):
            (out / name / "model-outputs-csv").mkdir(parents=True)
            _typed_cells().to_csv(out / name / "model-outputs-csv" / "tissue_deflate.csv",
                                  index=False)
            res = CliRunner().invoke(cli, [*args, "-o", str(out / name)],
                                     catch_exceptions=False)
            assert res.exit_code == 0, res.output
            assert "Output CSV exists... skipping." in res.output
    finally:
        mp.undo()
    np.testing.assert_array_equal(*(z[0] for z in z_lists))
    return out / "port", out / "jax"


@pytest.mark.parametrize("option,written", [
    ("--hplot", ["hplot-outputs.csv", "hmetrics-outputs.csv",
                 "hplot-outputs-csv/cells/tissue_deflate.csv",
                 "hplot-outputs-csv/hplots/tissue_deflate.csv",
                 "hplot-outputs-csv/hmetrics/tissue_deflate.json",
                 "hplot-outputs-geojson/tissue_deflate.geojson",
                 "hplot-outputs-omecsv/tissue_deflate.ome.csv.gz"]),
    ("--cme-cellular", ["cme-outputs-csv/cells/tissue_deflate.csv",
                        "cme-outputs-csv/cmes/tissue_deflate.csv",
                        "cme-outputs-geojson/cells/tissue_deflate.geojson"]),
])
def test_cli_run_analytics_options(analytics_runs, option, written):
    """`run` with the analytics options (refused before they were ported)
    writes the JAX CLI's files: the tables byte for byte, the GeoJSON
    features but for their ids (a fresh UUID per feature in each run), the
    OME-CSV's decompressed text."""
    import gzip
    import json

    port, jax_res = analytics_runs
    for rel in written:
        got, want = (port / rel).read_bytes(), (jax_res / rel).read_bytes()
        if rel.endswith(".geojson"):
            got, want = (json.loads(b)["features"] for b in (got, want))
            assert len({f.pop("id") for f in got}) == len(got) > 0
            for f in want:
                f.pop("id")
        elif rel.endswith(".gz"):
            got, want = gzip.decompress(got), gzip.decompress(want)
        else:  # a table: a header and rows
            assert got.count(b"\n") > 1, rel
        assert got == want, rel


@pytest.mark.parametrize("model", ["CellViT-Virchow-x40-AMP"])
def test_cli_patches_virchow_model(slides, tmp_path, model):
    """`patch` with the Virchow cell model (refused before its encoder was
    ported) plans the slide's halo grid."""
    from click.testing import CliRunner

    import h5py
    from wsinsight_tpu_torch.cli.cli import cli

    res = CliRunner().invoke(cli, ["patch", "-i", str(slides["deflate"].parent), "-o",
                                   str(tmp_path / "r"), "-m", model])
    assert res.exit_code == 0, res.output
    with h5py.File(tmp_path / "r" / "patches" / "tissue_deflate.h5", "r") as f:
        assert f["coords"].shape[0] > 0


@pytest.mark.parametrize("model,object_detection", [
    ("hovernet_fast_pannuke", None),  # end2end, from the registry's config
    ("pancancer-lymphocytes-inceptionv4.tcga", "stardist"),
    ("pancancer-lymphocytes-inceptionv4.tcga", None),  # object-based, no detector named
])
def test_model_flags_of_object_based_models(model, object_detection):
    """HoVer-Net and object-based StarDist configs are object-based for the
    CLI, with their halo, and Virchow's registered config is an end2end cell
    model with CellViT's halo of 46."""
    from wsinsight_tpu_torch.cli import _options as opt
    from wsinsight_tpu_torch.zoo import ObjectDetectionConfiguration, get_registered_model

    handle = get_registered_model(model)
    if object_detection is not None or not handle.config.object_based:
        handle.config.object_based = True
        handle.config.object_detection = (None if object_detection is None else
                                          ObjectDetectionConfiguration(name=object_detection))
    flags = opt.model_flags(handle)
    assert flags["object_based"]
    virchow = opt.model_flags(get_registered_model("CellViT-Virchow-x40-AMP"))
    assert virchow["object_based"] and virchow["halo_size_px"] == 46
    assert virchow["object_detection"] == "end2end"


def test_cli_refuses_multi_host(monkeypatch, tmp_path):
    from click.testing import CliRunner

    from wsinsight_tpu_torch.cli.cli import cli

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    res = CliRunner().invoke(cli, ["patch", "-i", str(tmp_path), "-o", str(tmp_path / "r"),
                                   "-m", "breast-tumor-resnet34.tcga-brca"])
    # a coordinator without the process count and rank is a usage error
    assert res.exit_code == 2
    assert "JAX_NUM_PROCESSES" in res.output and "JAX_PROCESS_ID" in res.output


def test_cli_commands_and_options_match_jax():
    """The port's patch / infer / run / hplot / cme / models (and models'
    ls / convert) take the JAX commands' options, names and defaults alike."""
    from wsinsight_tpu.cli.cli import cli as jax_cli
    from wsinsight_tpu_torch.cli.cli import cli as port_cli

    assert set(port_cli.commands) == {"patch", "infer", "run", "hplot", "cme", "models"}
    assert set(jax_cli.commands) == set(port_cli.commands)
    pairs = [(port_cli.commands[n], jax_cli.commands[n], n) for n in port_cli.commands]
    pairs += [(port_cli.commands["models"].commands[n], jax_cli.commands["models"].commands[n],
               f"models {n}") for n in ("ls", "convert")]
    assert set(port_cli.commands["models"].commands) == {"ls", "convert"}
    for port_cmd, jax_cmd, name in pairs:
        ours = {p.name: (p.opts, p.default) for p in port_cmd.params}
        theirs = {p.name: (p.opts, p.default) for p in jax_cmd.params}
        assert ours == theirs, name


def test_default_infer_workers(monkeypatch):
    from wsinsight_tpu_torch.cli.infer import default_infer_workers

    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    assert default_infer_workers() == max(1, min(__import__("os").cpu_count() or 1, 2))


def test_governed_workers_never_exceeds_request(monkeypatch):
    import sys

    from wsinsight_tpu_torch.utils.workers import governed_workers

    for requested in (1, 3, 64):
        assert 1 <= governed_workers(requested) <= requested
    monkeypatch.setitem(sys.modules, "psutil", None)  # a host without psutil
    assert governed_workers(5) == 5


def test_metadata_reports_torch_and_missing_h5py(monkeypatch):
    import sys

    from wsinsight_tpu_torch.utils.metadata import get_runtime_info

    monkeypatch.setitem(sys.modules, "h5py", None)
    info = get_runtime_info()
    assert info["devices"] == ["cpu"]
    assert info["versions"]["torch"] == torch.__version__
    assert info["versions"]["h5py"] is None
    assert "jax" not in info["versions"] and "flax" not in info["versions"]


def test_cli_requires_h5py(monkeypatch, slides, tmp_path):
    """Where h5py is missing (the card's machine), patch and infer stop with a
    plain message before any work."""
    import sys

    from click.testing import CliRunner

    from wsinsight_tpu_torch.cli.cli import cli

    monkeypatch.setitem(sys.modules, "h5py", None)
    for cmd in ("patch", "infer"):
        res = CliRunner().invoke(cli, [cmd, "-i", str(slides["deflate"].parent), "-o",
                                       str(tmp_path / "r"), "-m", "breast-tumor-resnet34.tcga-brca"])
        assert res.exit_code == 1 and "needs h5py" in res.output, res.output
    assert not (tmp_path / "r").exists()


def test_cli_runs_cell_model(tmp_path):
    """`run` with an end2end cell model (the port's seeded CellViT-256 at
    128 px, halo 16) plans the halo grid and writes one CSV row per nucleus
    and the /polygons group, aligned with the rows. The HV head is zeroed,
    as tests/test_cells.py does for its end-to-end run: random HV fields
    leave no seeds."""
    import json

    import h5py
    import pandas as pd
    from click.testing import CliRunner

    from wsinsight_tpu_torch.cli.cli import cli
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff
    from wsinsight_tpu_torch.zoo import make_random_local_model

    cfg, weights = make_random_local_model("cellvit-256", 6, tmp_path / "m", patch_size_pixels=128)
    config = json.loads(cfg.read_text())
    config["halo_size_pixels"] = 16
    cfg.write_text(json.dumps(config))
    state = torch.load(weights)
    for k in ("weight", "bias"):
        state[f"hv_map_decoder.decoder0_header.2.{k}"].zero_()
    torch.save(state, weights)
    (tmp_path / "slides").mkdir()
    write_pyramidal_tiff(str(tmp_path / "slides" / "cells.tif"), _tissue_image(768, seed=4),
                         tile=(256, 256), compression="deflate", mpp=0.25, levels=2)
    res = CliRunner().invoke(cli, [
        "run", "-i", str(tmp_path / "slides"), "-o", str(tmp_path / "r"), "--config", str(cfg),
        "--model-path", str(weights), "-b", "16", "--stitch-workers", "1",
        "--seg-thumbsize", "512", "512", "--seg-min-object-size-um2", "2500",
        "--seg-min-hole-size-um2", "100"], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    df = pd.read_csv(tmp_path / "r" / "model-outputs-csv" / "cells.csv")
    assert list(df.columns) == ["minx", "miny", "width", "height",
                                *(f"prob_class{i}" for i in range(6))]
    with h5py.File(tmp_path / "r" / "patches" / "cells.h5", "r") as f:
        coords, offsets = f["/coords"][()], f["/polygons/offsets"][()]
        rings = f["/polygons/coords"][()]
    print(f"cell run: {len(coords)} patches, {len(df)} instances")
    assert np.diff(np.unique(coords[:, 0])).min() == 96  # 128 - 2 * 16
    assert len(df) > 0 and len(offsets) == len(df) + 1
    for (x, y, w, h), a, b in zip(df[["minx", "miny", "width", "height"]].to_numpy(),
                                  offsets[:-1], offsets[1:]):
        ring = rings[a:b]
        assert len(ring) >= 3 and (ring.min(0) >= (x, y)).all()
        assert (ring.max(0) <= (x + w - 1, y + h - 1)).all()
