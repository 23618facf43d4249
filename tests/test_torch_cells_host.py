"""The port's cell path, host half, against the JAX package.

The same inputs, made from a numpy seed, go through each JAX function and
its copy in the port: the watershed (the port's native and Python versions
against the JAX package's), the HV post-processing stages, the stitcher's
tiled finalize on identical canvases (int and f32 basins, the device ridge),
the ridge's torch energy against cv2, and ``run_inference``'s end2end branch
on a small slide with one JAX-authored CellViT-256 checkpoint loaded by both
packages. The port runs on the CPU (WSINFER_FORCE_CPU=1), where its ridge
runs in torch on the CPU.

Tolerances: the watershed, the post-processing stages and finalize on
identical canvases are deterministic integer or cv2 recipes, held to
identical results; the torch energy to 2e-4 of cv2 (the JAX package's bar,
tests/test_cells.py) and 1e-5 of the JAX energy (both f32 shifted adds); the
end2end run to >= 99% of JAX's instances by identical bbox, probabilities
within 1/255 + 1e-3 (one level of the uint8 transfer on top of the maps'
1e-3 parity bar).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_cells import _synthetic_nuclei  # noqa: E402

ENV = ("WSINSIGHT_HV_BASIN", "WSINSIGHT_DEVICE_RIDGE", "WSINSIGHT_WIRE", "WSINSIGHT_PRECISION",
       "WSINSIGHT_STREAM_CELLS", "WSINSIGHT_CELL_TRANSFER", "WSINSIGHT_PROFILE",
       "WSINSIGHT_CANVAS_MEMMAP_BYTES", "JAX_COORDINATOR_ADDRESS")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _watershed_fuzz():
    """The four cases of tests/test_cells.py's native-vs-Python fuzz (seed 7):
    random images, masks and disc markers with interiors."""
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(4):
        h, w = rng.integers(40, 160, 2)
        img = rng.random((h, w)).astype(np.float32)
        mask = rng.random((h, w)) < 0.6
        markers = np.zeros((h, w), np.int32)
        yy, xx = np.mgrid[:h, :w]
        for lab in range(1, int(rng.integers(2, 7))):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            markers[np.hypot(yy - cy, xx - cx) < int(rng.integers(2, 12))] = lab
        markers[~mask] = 0
        cases.append((img, markers, mask))
    return cases


def _crowded_nuclei(h, w, n, seed, k=6):
    """NP / HV / TP maps of ``n`` seeded elliptic nuclei, many touching, with
    soft edges and noise: HV points from each nucleus' centre to its edge,
    TP favours one class per nucleus."""
    rng = np.random.default_rng(seed)
    np_map = np.zeros((h, w), np.float32)
    hv = np.zeros((h, w, 2), np.float32)
    owner = np.full((h, w), -1, np.int32)
    best = np.full((h, w), np.inf, np.float32)
    for i in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(6, 16, 2)
        y0, y1 = max(0, int(cy - 1.3 * ry)), min(h, int(cy + 1.3 * ry) + 1)
        x0, x1 = max(0, int(cx - 1.3 * rx)), min(w, int(cx + 1.3 * rx) + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        d = np.hypot((yy - cy) / ry, (xx - cx) / rx)
        win = (slice(y0, y1), slice(x0, x1))
        np_map[win] = np.maximum(np_map[win], np.clip(1.3 - d, 0, 1))
        take = (d < 1.2) & (d < best[win])
        best[win][take], owner[win][take] = d[take], i
        hv[win][take] = np.stack([(xx - cx) / rx, (yy - cy) / ry], -1)[take]
    np_map = np.clip(np_map + rng.normal(0, 0.08, np_map.shape), 0, 1).astype(np.float32)
    logits = rng.normal(0, 0.5, (h, w, k)).astype(np.float32)
    cls = rng.integers(1, k, n)
    logits[owner >= 0, cls[owner[owner >= 0]]] += 2.0
    tp = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return np_map, hv, tp.astype(np.float32)


def _random_maps(h, w, seed, k=6):
    """Smoothed seeded noise: blobby NP, random HV and TP fields."""
    import cv2

    rng = np.random.default_rng(seed)
    np_map = cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (0, 0), 3)
    np_map = (np_map - np_map.min()) / (np_map.max() - np_map.min())
    hv = cv2.GaussianBlur(rng.normal(0, 1, (h, w, 2)).astype(np.float32), (0, 0), 4)
    tp = rng.random((h, w, k)).astype(np.float32)
    return np_map, hv, tp / tp.sum(-1, keepdims=True)


MAPS = {
    "synthetic": lambda: _synthetic_nuclei(),
    "crowded": lambda: _crowded_nuclei(256, 224, 60, seed=1),
    "random": lambda: _random_maps(192, 256, seed=2),
}


def _assert_same_instances(got, want, prob_atol=0.0):
    """Two finalize / extract_instances results hold the same instances:
    lists aligned, and after sorting by (miny, minx, h, w) identical boxes and
    polygons, probabilities within ``prob_atol``."""
    for out in (got, want):
        assert len(out[0]) == len(out[1]) == len(out[2])
    assert len(got[0]) == len(want[0])
    if not want[0]:
        return

    def ordered(out):
        boxes = np.concatenate(out[0])
        order = np.lexsort((boxes[:, 3], boxes[:, 2], boxes[:, 0], boxes[:, 1]))
        return boxes[order], np.concatenate(out[1])[order], [out[2][i] for i in order]

    gb, gp, gpoly = ordered(got)
    wb, wp, wpoly = ordered(want)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_allclose(gp, wp, atol=prob_atol, rtol=0)
    for a, b in zip(gpoly, wpoly):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Watershed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(4))
def test_watershed_native_matches_python_and_jax(case):
    from wsinsight_tpu.native import watershed_native as jax_native
    from wsinsight_tpu.ops.watershed import _watershed_python as jax_python
    from wsinsight_tpu_torch.ops.watershed import _watershed_python, watershed

    img, markers, mask = _watershed_fuzz()[case]
    got = watershed(img, markers.copy(), mask)
    assert got.dtype == np.int32 and got.shape == img.shape
    np.testing.assert_array_equal(got, _watershed_python(img, markers.copy(), mask))
    np.testing.assert_array_equal(got, jax_native(img, markers.copy(), mask))
    np.testing.assert_array_equal(got, jax_python(img, markers.copy(), mask))
    assert set(np.unique(got)) - {0} == set(np.unique(markers)) - {0}


def test_watershed_separates_touching_blobs_and_takes_no_mask():
    from wsinsight_tpu_torch.ops.watershed import _watershed_python, watershed

    yy, xx = np.mgrid[:64, :64]
    img = np.minimum(np.hypot(yy - 20, xx - 20), np.hypot(yy - 20, xx - 40)).astype(np.float32)
    mask = img < 14
    markers = np.zeros((64, 64), np.int32)
    markers[20, 20], markers[20, 40] = 1, 2
    out = watershed(img, markers, mask)
    assert set(np.unique(out)) == {0, 1, 2} and (out[mask] > 0).all()
    assert out[20, 25] == 1 and out[20, 35] == 2
    # without a mask every pixel takes a label
    full = watershed(img, markers)
    assert (full > 0).all()
    np.testing.assert_array_equal(full, _watershed_python(img, markers, None))


@pytest.mark.parametrize("min_size", [0, 1, 5, 30])
def test_remove_small_labels_matches_jax(min_size):
    import cv2

    from wsinsight_tpu.ops.watershed import remove_small_labels as jax_remove
    from wsinsight_tpu_torch.ops.watershed import remove_small_labels

    rng = np.random.default_rng(min_size)
    _, labels = cv2.connectedComponents((rng.random((96, 80)) < 0.45).astype(np.uint8),
                                        connectivity=4, ltype=cv2.CV_32S)
    got = remove_small_labels(labels, min_size)
    np.testing.assert_array_equal(got, jax_remove(labels, min_size))
    if min_size > 1:
        sizes = np.bincount(got.ravel())
        assert (sizes[1:][sizes[1:] > 0] >= min_size).all()


# ---------------------------------------------------------------------------
# HV post-processing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_size", [0, 20])
@pytest.mark.parametrize("maps", sorted(MAPS))
def test_fill_holes_and_label_small_filtered_match_jax(maps, min_size):
    from wsinsight_tpu.ops import hv_postproc as jax_hv
    from wsinsight_tpu_torch.ops import hv_postproc as hv

    np_map = MAPS[maps]()[0]
    fg = (np_map >= 0.5).astype(np.uint8)
    got = hv._label_small_filtered(fg, min_size)
    np.testing.assert_array_equal(got, jax_hv._label_small_filtered(fg, min_size))
    ring = fg.copy()
    ring[np_map > 0.8] = 0  # blobs with holes
    np.testing.assert_array_equal(hv._fill_holes(ring), jax_hv._fill_holes(ring))
    assert (hv._fill_holes(ring) >= ring).all()


@pytest.mark.parametrize("basin", ["int", "f32"])
@pytest.mark.parametrize("maps", sorted(MAPS))
def test_extract_instances_matches_jax(monkeypatch, maps, basin):
    """Identical boxes, probabilities and polygons on the same tile, in the
    integer basin and under WSINSIGHT_HV_BASIN=f32; the interior slice and
    offsets as finalize passes them."""
    from wsinsight_tpu.ops.hv_postproc import extract_instances as jax_extract
    from wsinsight_tpu.ops.hv_postproc import segment_instances as jax_segment
    from wsinsight_tpu_torch.ops.hv_postproc import extract_instances, segment_instances

    if basin == "f32":
        monkeypatch.setenv("WSINSIGHT_HV_BASIN", "f32")
    np_map, hv_map, tp_map = MAPS[maps]()
    np_map[3, 3] = 1.0  # an isolated pixel: a degenerate contour, dropped from all three
    labels = segment_instances(np_map, hv_map, 10)
    np.testing.assert_array_equal(labels, jax_segment(np_map, hv_map, 10))
    args = (np_map, hv_map, tp_map, 100, 40, (slice(8, np_map.shape[0] - 8),
                                               slice(8, np_map.shape[1] - 8)))
    for min_size in (0, 20):
        got = extract_instances(*args, min_size)
        _assert_same_instances(got, jax_extract(*args, min_size))
        assert len(got[0]) >= (3 if maps == "synthetic" else 1)
        for box, ring in zip(got[0], got[2]):
            x, y, w, h = box[0]
            assert ring.min(0).tolist() >= [x, y] and ring.max(0).tolist() <= [x + w - 1, y + h - 1]


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_segment_instances_with_raw_energy_matches_jax(kind):
    from wsinsight_tpu.ops.hv_postproc import raw_separation_energy
    from wsinsight_tpu.ops.hv_postproc import segment_instances as jax_segment
    from wsinsight_tpu_torch.ops.hv_postproc import segment_instances

    np_map, hv_map, _ = MAPS["crowded"]()
    raw = raw_separation_energy(hv_map).astype(np.float32)
    if kind == "u8":
        raw = np.rint(raw * 255.0).astype(np.uint8)
    got = segment_instances(np_map, None, 20, raw_energy=raw)
    np.testing.assert_array_equal(got, jax_segment(np_map, None, 20, raw_energy=raw))
    assert got.max() > 10


def test_streaming_entry_points_match_jax():
    """The label-only entry points (a streaming engine's) agree too."""
    from wsinsight_tpu.ops import hv_postproc as jax_hv
    from wsinsight_tpu_torch.ops import hv_postproc as hv

    np_map, hv_map, _ = MAPS["crowded"]()
    raw = jax_hv.raw_separation_energy(hv_map)
    e_u8 = jax_hv._energy_u8(None, np_map >= 0.5, raw)
    basin = jax_hv._integer_basin(e_u8, np_map >= 0.5)
    inner = (slice(4, 250), slice(4, 220))
    pairs = [(hv.extract_instance_labels(np_map, raw, inner, 20),
              jax_hv.extract_instance_labels(np_map, raw, inner, 20)),
             (hv.extract_instance_labels_from_proposal(np_map >= 0.5, e_u8 >= 102, basin, inner, 20),
              jax_hv.extract_instance_labels_from_proposal(np_map >= 0.5, e_u8 >= 102, basin,
                                                           inner, 20))]
    for got, want in pairs:
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert len(got[3]) == len(want[3]) == len(got[1]) > 10
        for g, w in zip(got[3], want[3]):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The ridge's torch energy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", ["synthetic_and_noise", "flat_and_crowded"])
def test_separation_energy_matches_jax_and_cv2(batch):
    from wsinsight_tpu.ops.hv_device import separation_energy_batched as jax_energy
    from wsinsight_tpu.ops.hv_postproc import raw_separation_energy
    from wsinsight_tpu_torch.ops.hv_device import separation_energy_batched

    rng = np.random.default_rng(0)
    if batch == "synthetic_and_noise":
        tiles = [_synthetic_nuclei(128, 128)[1], rng.normal(0, 0.4, (128, 128, 2))]
    else:
        tiles = [np.zeros((160, 96, 2)), _crowded_nuclei(160, 96, 12, seed=4)[1]]
    hv = np.stack(tiles).astype(np.float32)
    got = separation_energy_batched(hv, "cpu")
    assert got.dtype == np.float32 and got.shape == hv.shape[:3]
    np.testing.assert_allclose(got, jax_energy(hv), atol=1e-5, rtol=0)
    for e, tile in zip(got, hv):
        np.testing.assert_allclose(e, raw_separation_energy(tile), atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------
# finalize on identical canvases
# ---------------------------------------------------------------------------


def _filled_stitchers(h=560, w=640, seed=5, k=6, **port_kw):
    """A port and a JAX stitcher whose canvases hold the same crowded maps
    (one nucleus per 1,600 px^2)."""
    from wsinsight_tpu.engine.stitch import TileRemapStitcher as JaxStitcher
    from wsinsight_tpu_torch.engine.stitch import TileRemapStitcher

    np_map, hv_map, tp_map = _crowded_nuclei(h, w, h * w // 1600, seed=seed, k=k)
    kw = dict(n_classes=k, slide_width=w, slide_height=h, slide_patch_size=164,
              slide_halo_size=46, slide_mpp=0.25, model_mpp=0.25)
    port, jax = TileRemapStitcher(**kw, **port_kw), JaxStitcher(**kw)
    for st in (port, jax):
        st.np_map[:], st.hv_map[:], st.tp_map[:] = np_map, hv_map, tp_map
    return port, jax


class _Count:
    n = 0

    def update(self, k):
        self.n += k


@pytest.mark.parametrize("basin", ["int", "f32"])
@pytest.mark.parametrize("workers", [1, 4])
def test_finalize_matches_jax(monkeypatch, workers, basin):
    """Edge tiles (640 x 560 in tiles of 256), 32 px of context; the instance
    sets are identical (order differs across workers, so sorted)."""
    if basin == "f32":
        monkeypatch.setenv("WSINSIGHT_HV_BASIN", "f32")
    port, jax = _filled_stitchers()
    pbar = _Count()
    got = port.finalize(tile_size=256, padding_size=32, pbar=pbar, num_workers=workers)
    want = jax.finalize(tile_size=256, padding_size=32, num_workers=workers)
    assert pbar.n == 9  # 3 x 3 tiles
    assert len(got[0]) > 100
    _assert_same_instances(got, want)
    boxes = np.concatenate(got[0])
    assert boxes[:, 0].min() >= 0 and (boxes[:, 0] + boxes[:, 2]).max() <= 640
    assert (boxes[:, 1] + boxes[:, 3]).max() <= 560


def test_finalize_default_workers_and_memmap_canvases(monkeypatch):
    """Canvases backed by memmaps above the threshold, and the adaptive
    worker count, give the same instances."""
    from wsinsight_tpu_torch.engine.stitch import TileRemapStitcher

    port, jax = _filled_stitchers(h=300, w=420)
    mm = TileRemapStitcher(n_classes=6, slide_width=420, slide_height=300, slide_patch_size=164,
                           slide_halo_size=46, slide_mpp=0.25, model_mpp=0.25,
                           memmap_above_bytes=1)
    assert isinstance(mm.np_map, np.memmap)
    mm.np_map[:], mm.hv_map[:], mm.tp_map[:] = port.np_map, port.hv_map, port.tp_map
    want = jax.finalize(tile_size=256, padding_size=32, num_workers=1)
    _assert_same_instances(port.finalize(tile_size=256, padding_size=32), want)
    _assert_same_instances(mm.finalize(tile_size=256, padding_size=32, num_workers=2), want)
    mm.close()
    assert mm.np_map is None
    empty = TileRemapStitcher(6, 0, 0, 164, 46, 0.25, 0.25)
    assert empty.finalize() == ([], [], [])


def test_finalize_device_ridge_same_instances(monkeypatch):
    """WSINSIGHT_DEVICE_RIDGE=1: the energy of the full tiles runs in torch on
    the stitcher's device (chunks of 8, the tail padded); the instances are
    those of the cv2 path and of the JAX package's ridge."""
    import wsinsight_tpu_torch.ops.hv_device as hv_device

    port, jax = _filled_stitchers(h=800, w=1100, seed=6, device="cpu")
    cpu_path = port.finalize(tile_size=128, padding_size=32, num_workers=2)
    monkeypatch.setenv("WSINSIGHT_DEVICE_RIDGE", "1")
    calls = []
    energy = hv_device.separation_energy_batched

    def counted(hv, device):
        calls.append((hv.shape, str(device)))
        return energy(hv, device)

    monkeypatch.setattr(hv_device, "separation_energy_batched", counted)
    ridge = port.finalize(tile_size=128, padding_size=32, num_workers=2)
    jax_ridge = jax.finalize(tile_size=128, padding_size=32, num_workers=2)
    # 7 x 9 tiles: the 5 x 7 interior ones share the most common shape (192^2)
    assert [c[0] for c in calls] == [(8, 192, 192, 2)] * 5 and {c[1] for c in calls} == {"cpu"}
    assert len(ridge[0]) > 300
    _assert_same_instances(ridge, cpu_path, prob_atol=1e-5)
    _assert_same_instances(ridge, jax_ridge, prob_atol=1e-5)


def test_device_ridge_never_leaves_its_device(monkeypatch):
    """With the ridge on, a stitcher that resolves to the card where there is
    none raises; it does not run the energy on the CPU instead."""
    from wsinsight_tpu_torch.engine.stitch import TileRemapStitcher

    monkeypatch.delenv("WSINFER_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WSINSIGHT_DEVICE_RIDGE", "1")
    for device in (None, "cuda"):
        st = TileRemapStitcher(3, 256, 256, 164, 0, 0.25, 0.25, device=device)
        st.np_map[:], st.hv_map[:], st.tp_map[:] = _synthetic_nuclei()
        with pytest.raises(RuntimeError, match="CUDA is not available|no CUDA device"):
            st.finalize(tile_size=128, padding_size=32, num_workers=1)


# ---------------------------------------------------------------------------
# run_inference, end2end, port vs JAX
# ---------------------------------------------------------------------------

SLIDE_SIDE = 640


@pytest.fixture(scope="module")
def cell_run(tmp_path_factory):
    """One JAX-authored CellViT-256 checkpoint (flax init, seed 0) at 128 px
    with a halo of 16, loaded by both packages, and a 640 px slide of
    nucleus-like ellipses on H&E pink, planned and run by each package's
    patch stage and run_inference (one stitch worker).

    As tests/test_cells.py does for its end-to-end run, the NP head's bias is
    moved (here by 0.48 toward background, so about a third of the pixels are
    foreground) and the HV head zeroed: random HV fields leave no seeds, so a
    random model would find no nuclei."""
    from wsinsight_tpu.models.convert import load_flax_params, save_flax_params
    from wsinsight_tpu.zoo import make_random_local_model as jax_make_random
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    d = tmp_path_factory.mktemp("cell_run")
    cfg, weights = jax_make_random("cellvit-256", 6, d / "model", patch_size_pixels=128)
    config = json.loads(cfg.read_text())
    config["halo_size_pixels"] = 16
    cfg.write_text(json.dumps(config))
    params = load_flax_params(weights)
    np_head = params["nuclei_binary_map_decoder"]["decoder0_header.2"]
    np_head["bias"] = np.asarray(np_head["bias"]) + np.array([0.24, -0.24], np.float32)
    hv_head = params["hv_map_decoder"]["decoder0_header.2"]
    hv_head["kernel"] = np.zeros_like(np.asarray(hv_head["kernel"]))
    hv_head["bias"] = np.zeros_like(np.asarray(hv_head["bias"]))
    save_flax_params(params, weights)

    rng = np.random.default_rng(0)
    side = SLIDE_SIDE
    img = np.full((side, side, 3), 236, np.int16)
    yy, xx = np.mgrid[:side, :side]
    img[((yy - side / 2) / (0.43 * side)) ** 2 + ((xx - side / 2) / (0.44 * side)) ** 2 <= 1] = (
        214, 132, 186)
    for _ in range(110):
        cy, cx = rng.uniform(0.08, 0.92, 2) * side
        ry, rx = rng.uniform(4, 9, 2)
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = (120, 60, 150)
    img += rng.integers(-8, 9, img.shape, dtype=np.int16)
    slides = d / "slides"
    slides.mkdir()
    write_pyramidal_tiff(str(slides / "cells.tif"), np.clip(img, 0, 255).astype(np.uint8),
                         tile=(256, 256), compression="deflate", mpp=0.25, levels=2)

    import wsinsight_tpu.engine as jax_engine
    import wsinsight_tpu.patchlib as jax_patchlib
    import wsinsight_tpu.uri_path as jax_uri
    import wsinsight_tpu.zoo as jax_zoo
    import wsinsight_tpu_torch.engine as port_engine
    import wsinsight_tpu_torch.patchlib as port_patchlib
    import wsinsight_tpu_torch.uri_path as port_uri
    import wsinsight_tpu_torch.zoo as port_zoo

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WSINFER_FORCE_CPU", "1")
        mp.setenv("WSINSIGHT_STREAM_CELLS", "0")  # the JAX host-canvas engine, as the port's
        for var in ENV[:-1]:
            if var != "WSINSIGHT_STREAM_CELLS":
                mp.delenv(var, raising=False)
        for name, engine, patchlib, uri, zoo in (
            ("jax", jax_engine, jax_patchlib, jax_uri, jax_zoo),
            ("port", port_engine, port_patchlib, port_uri, port_zoo),
        ):
            results = d / f"results_{name}"
            patchlib.segment_and_patch_one_slide(
                slide_path=uri.URIPath(str(slides / "cells.tif")),
                save_dir=uri.URIPath(str(results)), qupath_detection_dir=None,
                qupath_geojson_detection_dir=None, qupath_geojson_annotation_dir=None,
                patch_size_px=128, patch_spacing_um_px=0.25, halo_size_px=16,
                object_based=True, object_detection="end2end", thumbsize=(512, 512),
                min_object_size_um2=50**2, min_hole_size_um2=10**2)
            failed = engine.run_inference(
                wsi_dir=None, slide_paths=None, results_dir=uri.URIPath(str(results)),
                model_info=zoo.load_local_model(cfg, weights), halo_size_px=16, batch_size=8,
                num_workers=1, object_based=True, object_detection="end2end",
                stitch_workers=1)
            out[name] = (results, failed)
    return out, (cfg, weights)


def _cells_csv_and_rings(results):
    import h5py
    import pandas as pd

    df = pd.read_csv(results / "model-outputs-csv" / "cells.csv")
    with h5py.File(results / "patches" / "cells.h5", "r") as f:
        coords = f["/coords"][()]
        flat, offsets = f["/polygons/coords"][()], f["/polygons/offsets"][()]
    rings = [flat[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
    return df, rings, coords


def test_run_inference_end2end_matches_jax(cell_run):
    out, _ = cell_run
    (jax_results, jax_failed), (port_results, port_failed) = out["jax"], out["port"]
    assert jax_failed == port_failed == ([], [])
    want, want_rings, want_coords = _cells_csv_and_rings(jax_results)
    got, got_rings, got_coords = _cells_csv_and_rings(port_results)
    np.testing.assert_array_equal(got_coords, want_coords)  # the same halo plan
    assert len(want_coords) >= 20
    cols = ["minx", "miny", "width", "height"]
    prob_cols = [f"prob_class{i}" for i in range(6)]
    assert list(got.columns) == list(want.columns) == cols + prob_cols
    assert len(got) == len(got_rings) and len(want) == len(want_rings)
    assert len(want) > 100
    p = got[prob_cols].to_numpy()
    assert np.isfinite(p).all() and np.abs(p.sum(1) - 1).max() <= 6 * 0.5 / 255 + 1e-5

    got_index = {tuple(r): i for i, r in enumerate(got[cols].to_numpy().tolist())}
    matched = [(i, got_index[tuple(r)]) for i, r in enumerate(want[cols].to_numpy().tolist())
               if tuple(r) in got_index]
    print(f"end2end: JAX {len(want)} instances, port {len(got)}, {len(matched)} with an"
          " identical bbox")
    assert len(matched) >= 0.99 * len(want)
    wi, gi = (np.array(ix) for ix in zip(*matched))
    dp = np.abs(got[prob_cols].to_numpy()[gi] - want[prob_cols].to_numpy()[wi])
    assert dp.max() <= 1 / 255 + 1e-3
    for a, b in matched:
        np.testing.assert_array_equal(got_rings[b], want_rings[a])


def test_run_inference_end2end_lists_a_failed_slide(cell_run, tmp_path):
    """A slide whose inference fails is logged and listed, and gets no CSV."""
    from wsinsight_tpu_torch.engine import run_inference
    from wsinsight_tpu_torch.patchlib.io import save_hdf5
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.zoo import load_local_model

    out, (cfg, weights) = cell_run
    results = tmp_path / "results"
    (results / "patches").mkdir(parents=True)
    save_hdf5(results / "patches" / "gone.h5", np.array([[0, 0]]), None, None, 128, 0.25,
              slide_path=str(tmp_path / "gone.tif"), slide_mpp=0.25, slide_width=256,
              slide_height=256)
    failed = run_inference(None, None, URIPath(str(results)),
                           model_info=load_local_model(cfg, weights), halo_size_px=16,
                           batch_size=8, num_workers=1, object_based=True,
                           object_detection="end2end", stitch_workers=1)
    assert failed == ([], ["gone"])
    assert not (results / "model-outputs-csv" / "gone.csv").exists()
