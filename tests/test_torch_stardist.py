"""The port's StarDist (U-Net, host helpers, weights, tiled inference) and the
object-based patch stage it serves, against the JAX package.

Same weights through both: the flax U-Net's param tree filled from numpy by
``random_flax_params``, carried into torch by ``flax_params_to_state_dict``,
or one weights file (a Keras HDF5 in the released layout, or a flax
msgpack) that both packages load. Bars: the U-Net's prob within 1e-5 and
dist within 1e-4 (tests/test_model_parity.py's StarDist bar); the numpy
helpers identical; plans with identical coords and polygons within 1e-3 px,
where a nucleus may differ only at a score within 1e-5 of 0.5 (the
threshold) or of another score (the NMS order), listed when it does. The
port runs on the CPU."""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flax_random_params import random_flax_params  # noqa: E402
from test_aux import _SD_LAYERS, _write_fake_keras_h5  # noqa: E402
from test_torch_hoststack import _tissue_image  # noqa: E402
from wsinsight_tpu.models import stardist as jax_sd  # noqa: E402
from wsinsight_tpu.models.convert import convert_stardist_keras_h5 as jax_convert  # noqa: E402
from wsinsight_tpu_torch.models import stardist as sd  # noqa: E402
from wsinsight_tpu_torch.models.convert import (  # noqa: E402
    convert_stardist_keras_h5,
    flax_params_to_state_dict,
    save_flax_msgpack,
)

WEIGHTS = "stardist_2D_versatile_he"
SLIDE_PX = 2048
# the object-based classifier's patch: the lymphocyte model's 100 px at 0.5
# um/px, 200 px on the 0.25 um/px slide
PATCH = dict(patch_size_px=100, patch_spacing_um_px=0.5)
TARGET_CANDIDATES = 300  # above prob 0.5 on the slide, set by the prob bias


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")


def _unet_params(seed: int = 0):
    return random_flax_params(jax_sd.StarDistUNet(), 0, 64, seed=seed)


def _port_unet(params) -> sd.StarDistUNet:
    model = sd.StarDistUNet()
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return model.eval()


def test_unet_matches_flax():
    flax_model, params = _unet_params()
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    want_p, want_d = jax.jit(flax_model.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        prob, dist = _port_unet(params)(torch.from_numpy(x))
    assert prob.shape == (2, 32, 32, 1) and dist.shape == (2, 32, 32, sd.N_RAYS)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want_p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_d), atol=1e-4, rtol=0)
    assert np.asarray(want_d).std() > 0.1 and 0.01 < np.asarray(want_p).std()


@pytest.mark.parametrize("pmin,pmax", [(1.0, 99.8), (0.0, 100.0), (3.0, 97.0)])
def test_normalize_percentile_matches_jax(pmin, pmax):
    img = np.random.default_rng(2).integers(0, 256, (97, 131, 3), dtype=np.uint8)
    np.testing.assert_array_equal(sd.normalize_percentile(img, pmin, pmax),
                                  jax_sd.normalize_percentile(img, pmin, pmax))
    flat = np.full((8, 8, 3), 7, np.uint8)  # constant image: the guarded divide
    np.testing.assert_array_equal(sd.normalize_percentile(flat, pmin, pmax),
                                  jax_sd.normalize_percentile(flat, pmin, pmax))


def _candidate_maps(seed: int, side: int = 96):
    rng = np.random.default_rng(seed)
    prob = rng.random((side, side)).astype(np.float32)
    dist = (rng.standard_normal((side, side, sd.N_RAYS)) * 3 + 6).astype(np.float32)
    return prob, dist


@pytest.mark.parametrize("grid,thresh", [(1, 0.5), (2, 0.5), (2, 0.97), (2, 1.0)])
def test_candidates_polys_and_nms_match_jax(grid, thresh):
    """_ray_candidates, _rays_to_polys and _nms give the JAX package's arrays
    and decisions on the same seeded maps (negative rays clipped)."""
    prob, dist = _candidate_maps(grid)
    got = sd._ray_candidates(prob, dist, thresh, grid=grid)
    want = jax_sd._ray_candidates(prob, dist, thresh, grid=grid)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    scores, centers, rays = got
    np.testing.assert_array_equal(sd._rays_to_polys(centers, rays),
                                  jax_sd._rays_to_polys(centers, rays))
    kept = sd._nms(scores, centers, rays, 0.4)
    assert kept == jax_sd._nms(scores, centers, rays, 0.4)
    assert (len(kept) == 0) == (thresh >= 1.0)
    assert len(kept) < max(1, len(scores))  # the NMS suppresses


def test_binned_nms_matches_allpairs_greedy():
    """The spatially binned NMS makes the decisions of the all-pairs greedy
    scan on a dense random candidate set."""
    rng = np.random.default_rng(0)
    n = 600
    centers = rng.uniform(0, 400, size=(n, 2)).astype(np.float32)
    rays = rng.uniform(3.0, 14.0, size=(n, sd.N_RAYS)).astype(np.float32)
    scores = rng.uniform(0.5, 1.0, size=n).astype(np.float32)
    mean_r = np.maximum(rays.mean(axis=1), 1.0)
    kept: list[int] = []
    for i in np.argsort(-scores, kind="stable"):
        if all(np.hypot(*(centers[i] - centers[j])) >= 0.4 * (mean_r[i] + mean_r[j])
               for j in kept):
            kept.append(int(i))
    assert sd._nms(scores, centers, rays) == kept


def _write_keras_h5(path, rng) -> None:
    """A Keras weights file in the released layout, as test_aux's
    _write_fake_keras_h5 writes it, with kernels at variance 2/fan-in (its
    N(0, 0.1^2) kernels grow the maps to logits of 1e4, where float32's
    rounding alone moves prob by 1e-4), a prob head scaled down so that prob
    does not saturate at 1 (where equal scores leave the NMS order to
    rounding) and rays of about 6 px."""
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n, _ in _SD_LAYERS])
        for name, kshape in _SD_LAYERS:
            g = f.create_group(name)
            if kshape is None:
                g.attrs["weight_names"] = np.array([], dtype="S1")
                continue
            k = rng.normal(0, np.sqrt(2 / np.prod(kshape[:-1])), size=kshape)
            b = rng.normal(0, 0.05, size=kshape[-1])
            if name == "prob":
                k *= 0.2
            if name == "dist":
                b += 6.0
            g.attrs["weight_names"] = np.array([f"{name}/kernel:0".encode(),
                                                f"{name}/bias:0".encode()])
            g.create_dataset(f"{name}/kernel:0", data=k.astype(np.float32))
            g.create_dataset(f"{name}/bias:0", data=b.astype(np.float32))


def test_keras_h5_conversion_matches_jax(tmp_path):
    """The released layout (anonymous grid-stem convs; test_aux's file)
    converts to the state dict that the JAX package's conversion carries
    across, which loads with strict=True."""
    h5 = tmp_path / "weights_best.h5"
    _write_fake_keras_h5(h5, np.random.default_rng(3))
    got = convert_stardist_keras_h5(h5)
    want = flax_params_to_state_dict(jax_convert(h5))
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    sd.StarDistUNet().load_state_dict(got, strict=True)


def test_keras_h5_truncated_raises_as_jax(tmp_path):
    h5 = tmp_path / "truncated.h5"
    _write_fake_keras_h5(h5, np.random.default_rng(4))
    with h5py.File(h5, "a") as f:
        del f["features"]
        f.attrs["layer_names"] = np.array([n.encode() for n, _ in _SD_LAYERS if n != "features"])
    with pytest.raises(ValueError, match="missing") as got:
        convert_stardist_keras_h5(h5)
    with pytest.raises(ValueError, match="missing") as want:
        jax_convert(h5)
    assert str(got.value) == str(want.value)


def test_keras_h5_without_h5py_says_so(tmp_path, monkeypatch):
    h5 = tmp_path / "weights_best.h5"
    _write_fake_keras_h5(h5, np.random.default_rng(5))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py, which is not installed"):
        convert_stardist_keras_h5(h5)


def test_save_flax_msgpack_writes_flax_bytes(tmp_path):
    """The port's msgpack writer gives flax.serialization's bytes for the
    same tree (torch tensors written as their arrays), which both packages
    read back."""
    from flax import serialization

    from wsinsight_tpu.models.convert import load_flax_params
    from wsinsight_tpu_torch.models.convert import load_flax_msgpack

    _, params = _unet_params(seed=2)
    tree = {m: {"bias": torch.from_numpy(v["bias"]), "kernel": v["kernel"]}
            for m, v in params.items()}
    save_flax_msgpack(tree, tmp_path / "w.msgpack")
    assert (tmp_path / "w.msgpack").read_bytes() == serialization.msgpack_serialize(params)
    for loaded in (load_flax_msgpack(tmp_path / "w.msgpack"),
                   load_flax_params(tmp_path / "w.msgpack")):
        for m, leaves in params.items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(np.asarray(loaded[m][k]), v)


def test_missing_weights_error_is_jaxs(tmp_path, monkeypatch):
    from wsinsight_tpu.zoo import WeightsNotFoundError as JaxWeightsNotFound
    from wsinsight_tpu_torch.zoo import WeightsNotFoundError

    monkeypatch.setenv("WSINSIGHT_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("KERAS_HOME", str(tmp_path / "keras"))
    with pytest.raises(WeightsNotFoundError) as got:
        sd.StarDist2D()
    with pytest.raises(JaxWeightsNotFound) as want:
        jax_sd.StarDist2D(params=None)
    assert str(got.value) == str(want.value)


def test_no_card_raises(monkeypatch):
    """No fallback: without a card, and without the CPU asked for, StarDist
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    monkeypatch.delenv("WSINFER_FORCE_CPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sd.StarDist2D(state_dict=flax_params_to_state_dict(_unet_params()[1]))


@pytest.mark.parametrize("fmt", ["h5", "msgpack"])
def test_weights_autoload_from_model_dir(tmp_path, monkeypatch, fmt):
    """The patch stage's StarDist loads its weights from WSINSIGHT_MODEL_DIR
    (the released Keras file, or a msgpack the port writes) and predicts the
    JAX package's polygons on the same normalized image."""
    rng = np.random.default_rng(5)
    h5 = tmp_path / f"{WEIGHTS}.h5"
    _write_keras_h5(h5, rng)
    if fmt == "msgpack":
        save_flax_msgpack(jax_convert(h5), tmp_path / f"{WEIGHTS}.msgpack")
        h5.unlink()
    monkeypatch.setenv("WSINSIGHT_MODEL_DIR", str(tmp_path))
    img = sd.normalize_percentile(rng.integers(0, 255, (96, 96, 3)).astype(np.float32), 1, 99.8)
    got = sd.StarDist2D().predict_instances_big(img, block_size=64, context=16)
    want = jax_sd.StarDist2D().predict_instances_big(img, block_size=64, context=16)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    """One 2048 px tissue slide at 0.25 um/px (deflate, 3 levels), alone in
    its directory, and its level 0."""
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    d = tmp_path_factory.mktemp("sdslide")
    img = _tissue_image(SLIDE_PX, seed=3)
    write_pyramidal_tiff(str(d / "tissue.tif"), img, tile=(256, 256), compression="deflate",
                         mpp=0.25, levels=3)
    return d / "tissue.tif", img


@pytest.fixture(scope="module")
def seeded_weights(tmp_path_factory, slide):
    """A WSINSIGHT_MODEL_DIR holding seeded U-Net weights as the released
    name's msgpack, and the port's maps of the slide's one block. Random
    weights put prob near 0.5 everywhere: the prob bias is set from a probe
    of the slide so that TARGET_CANDIDATES pixels lie above 0.5, the
    threshold halfway between two logits; dist is rescaled to rays of
    about 8 px, so the NMS has disks to weigh."""
    _, params = _unet_params(seed=1)
    params["dist"]["kernel"] *= 0.5
    params["dist"]["bias"][:] = 8.0
    img = sd.normalize_percentile(slide[1], 1.0, 99.8)
    model = _port_unet(params)
    logits = []
    model.prob.register_forward_hook(lambda m, i, o: logits.append(o))
    with torch.no_grad():
        model(torch.from_numpy(img[None]))
    top = np.sort(logits[0].numpy().ravel())[::-1][TARGET_CANDIDATES - 1:TARGET_CANDIDATES + 1]
    params["prob"]["bias"] -= np.float32(top.mean())
    d = tmp_path_factory.mktemp("sdweights")
    save_flax_msgpack(params, d / f"{WEIGHTS}.msgpack")
    net = sd.StarDist2D(flax_params_to_state_dict(params), device="cpu")
    prob, dist = net.predict_tile(img)
    return d, params, img, prob, dist


def test_slide_block_matches_jax(seeded_weights):
    """The slide's one block (2048 px, the whole level 0) through both
    packages' StarDist2D.predict_tile: prob within 1e-5, dist within 1e-4,
    and the candidates above 0.5 the same except where prob is within 1e-5
    of 0.5."""
    _, params, img, prob, dist = seeded_weights
    want_p, want_d = jax_sd.StarDist2D(params=params).predict_tile(img)
    assert prob.shape == want_p.shape == (SLIDE_PX // 2, SLIDE_PX // 2)
    np.testing.assert_allclose(prob, want_p, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dist, want_d, atol=1e-4, rtol=0)
    flips = np.argwhere((prob > 0.5) != (want_p > 0.5))
    print(f"candidates: {int((prob > 0.5).sum())} (port), {int((want_p > 0.5).sum())} (JAX);"
          f" flipped at the threshold: {flips.tolist()}")
    assert all(abs(prob[y, x] - 0.5) <= 1e-5 for y, x in flips)
    assert TARGET_CANDIDATES // 2 <= int((prob > 0.5).sum()) <= 2 * TARGET_CANDIDATES


def _differing_nuclei_are_ties(got_rings, want_rings, prob) -> list:
    """Centres (x, y) of the nuclei one plan has and the other lacks, or holds
    at another rank; each must score within 1e-5 of 0.5 or of another
    candidate's score. Returns them (empty when the plans agree)."""
    def centres(rings):
        return [tuple(np.rint(r[:-1].mean(0)).astype(int)) for r in rings]

    a, b = centres(got_rings), centres(want_rings)
    differing = sorted((set(a) ^ set(b)) | {c for c, d in zip(a, b) if c != d})
    scores = prob[prob > 0.5 - 1e-5]
    for x, y in differing:
        s = prob[y // 2, x // 2]
        near = np.sort(np.abs(scores - s))[1] if len(scores) > 1 else np.inf
        assert abs(s - 0.5) <= 1e-5 or near <= 1e-5, (x, y, s)
    return differing


def test_plan_slide_stardist_matches_jax(seeded_weights, slide, tmp_path, monkeypatch):
    """plan_slide in StarDist mode (object_based, object_detection="stardist")
    against the JAX package's patch stage on the same slide and weights:
    identical /coords, polygons within 1e-3 px."""
    from wsinsight_tpu.patchlib import segment_and_patch_one_slide as jax_patch
    from wsinsight_tpu.patchlib.io import read_polygons_group
    from wsinsight_tpu.uri_path import URIPath as JaxURIPath
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath

    weights_dir, *_, prob, _ = seeded_weights
    monkeypatch.setenv("WSINSIGHT_MODEL_DIR", str(weights_dir))
    opts = dict(qupath_detection_dir=None, qupath_geojson_detection_dir=None,
                qupath_geojson_annotation_dir=None, thumbsize=(1024, 1024),
                min_object_size_um2=50**2, min_hole_size_um2=10**2, object_based=True,
                object_detection="stardist", **PATCH)
    plan, ctx, *_ = plan_slide(URIPath(str(slide[0])), **opts)
    ctx.slide.close()
    jax_patch(slide_path=JaxURIPath(str(slide[0])), save_dir=JaxURIPath(str(tmp_path)), **opts)
    with h5py.File(tmp_path / "patches" / "tissue.h5", "r") as f:
        want_coords = f["/coords"][()]
        want_rings = read_polygons_group(f)
    assert plan.patch_size == 200 and plan.tile_dim is None
    assert 20 <= len(plan.coords) <= len(plan.polygons)  # nuclei in tissue, and on glass
    assert all(len(r) == sd.N_RAYS + 1 and np.array_equal(r[0], r[-1]) for r in plan.polygons)
    ties = _differing_nuclei_are_ties(plan.polygons, want_rings, prob)
    print(f"{len(plan.polygons)} nuclei, {len(plan.coords)} in tissue; differing at ties: {ties}")
    if not ties:
        np.testing.assert_array_equal(plan.coords, want_coords[:, :2])
        np.testing.assert_allclose(np.concatenate(plan.polygons), np.concatenate(want_rings),
                                   atol=1e-3, rtol=0)


def test_plan_slide_stardist_times_stages_and_logs_counts(seeded_weights, slide, monkeypatch,
                                                         caplog):
    """With stage timing on, plan_slide in StarDist mode times each of its
    steps under ``stardist.*`` and logs its counts (blocks, candidates,
    those in the blocks' interiors, kept) as the record's
    ``stardist_counts``, which agree with the plan."""
    import logging

    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath
    from wsinsight_tpu_torch.utils import profiling

    monkeypatch.setenv("WSINSIGHT_MODEL_DIR", str(seeded_weights[0]))
    monkeypatch.setattr(profiling, "_PROF_ENABLED", True)
    profiling.hot_stage_report(reset=True)
    with caplog.at_level(logging.INFO, logger=sd.__name__):
        plan, ctx, *_ = plan_slide(URIPath(str(slide[0])), None, None, None, 100, 0.5,
                                   object_based=True, object_detection="stardist")
    ctx.slide.close()
    report = profiling.hot_stage_report()
    stages = {k: v for k, v in report.items() if k.startswith("stardist.")}
    assert sorted(stages) == [f"stardist.{k}" for k in (
        "candidates", "copy_in", "copy_out", "forward", "nms", "normalize", "read")]
    assert all(v > 0 for v in stages.values()), stages
    # the plan's own spans hold them: StarDist's steps run inside plan.select
    assert sorted(set(report) - set(stages)) == ["plan.open", "plan.polygonize", "plan.select",
                                                 "plan.thumbnail", "plan.tissue_mask",
                                                 "plan_slide"]
    assert report["plan.select"] >= stages["stardist.forward"]
    counts = [r.stardist_counts for r in caplog.records if hasattr(r, "stardist_counts")]
    assert len(counts) == 1 and counts[0]["blocks"] == 1  # 2048 px: one block
    assert counts[0]["candidates"] >= counts[0]["interior"] >= counts[0]["kept"]
    assert counts[0]["kept"] == len(plan.polygons) > 0


def test_cli_patch_stardist_matches_jax(seeded_weights, slide, tmp_path, monkeypatch):
    """`patch` with an object-based StarDist local config, the port's CLI
    against the JAX CLI: the same /coords and /polygons."""
    from click.testing import CliRunner

    from wsinsight_tpu.cli.cli import cli as jax_cli
    from wsinsight_tpu.patchlib.io import read_polygons_group
    from wsinsight_tpu_torch.cli.cli import cli

    weights_dir, *_, prob, _ = seeded_weights
    monkeypatch.setenv("WSINSIGHT_MODEL_DIR", str(weights_dir))
    cfg = {"architecture": "inception_v4nobn", "num_classes": 2,
           "class_names": ["Other", "Lymphocytes"], "patch_size_pixels": 100,
           "spacing_um_px": 0.5, "transform": [{"name": "Resize", "arguments": {"size": 100}},
                                               {"name": "ToTensor"}],
           "object_based": True, "object_detection": {"name": "stardist"}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "w.pt").write_bytes(b"the patch stage reads no weights")
    out = {}
    for name, command in (("port", cli), ("jax", jax_cli)):
        res = CliRunner().invoke(command, [
            "patch", "-i", str(slide[0].parent), "-o", str(tmp_path / name),
            "--config", str(tmp_path / "cfg.json"), "--model-path", str(tmp_path / "w.pt"),
            "--seg-thumbsize", "1024", "1024", "--seg-min-object-size-um2", "2500",
            "--seg-min-hole-size-um2", "100"], catch_exceptions=False)
        assert res.exit_code == 0, res.output
        with h5py.File(tmp_path / name / "patches" / "tissue.h5", "r") as f:
            out[name] = (f["/coords"][()], read_polygons_group(f))
    (got_coords, got_rings), (want_coords, want_rings) = out["port"], out["jax"]
    assert len(got_coords) >= 20 and got_coords.shape[1] == want_coords.shape[1]
    ties = _differing_nuclei_are_ties(got_rings, want_rings, prob)
    if not ties:
        np.testing.assert_array_equal(got_coords, want_coords)
        np.testing.assert_allclose(np.concatenate(got_rings), np.concatenate(want_rings),
                                   atol=1e-3, rtol=0)


def test_cli_run_object_based_classifier_on_stardist_nuclei(seeded_weights, slide, tmp_path,
                                                           monkeypatch):
    """`run` with an object-based StarDist classifier config (a seeded
    ResNet34 at 100 px on 0.5 um/px): the patch stage plans StarDist's
    nuclei, and infer writes one CSV row per nucleus in tissue, each a
    200 px box centred on its nucleus's star polygon."""
    import pandas as pd
    from click.testing import CliRunner

    from wsinsight_tpu.patchlib.io import read_polygons_group
    from wsinsight_tpu_torch.cli.cli import cli
    from wsinsight_tpu_torch.geometry import polygon_centroid
    from wsinsight_tpu_torch.zoo import make_random_local_model

    monkeypatch.setenv("WSINSIGHT_MODEL_DIR", str(seeded_weights[0]))
    cfg_path, weights = make_random_local_model("resnet34", 2, tmp_path / "m",
                                                patch_size_pixels=100, spacing_um_px=0.5,
                                                resize_size=64)
    cfg = json.loads(cfg_path.read_text())
    cfg.update(object_based=True, object_detection={"name": "stardist"})
    cfg_path.write_text(json.dumps(cfg))
    res = CliRunner().invoke(cli, [
        "run", "-i", str(slide[0].parent), "-o", str(tmp_path / "r"), "--config", str(cfg_path),
        "--model-path", str(weights), "-b", "64", "--seg-thumbsize", "1024", "1024",
        "--seg-min-object-size-um2", "2500", "--seg-min-hole-size-um2", "100"],
        catch_exceptions=False)
    assert res.exit_code == 0, res.output
    df = pd.read_csv(tmp_path / "r" / "model-outputs-csv" / "tissue.csv")
    with h5py.File(tmp_path / "r" / "patches" / "tissue.h5", "r") as f:
        coords, rings = f["/coords"][()], read_polygons_group(f)
    assert len(df) == len(coords) >= 20 and (df["width"] == 200).all()
    np.testing.assert_array_equal(df[["minx", "miny"]].to_numpy(), coords[:, :2])
    centroids = {tuple(np.rint(polygon_centroid(r.astype(np.float64))).astype(int))
                 for r in rings}
    assert all((x + 100, y + 100) in centroids for x, y in coords[:, :2])
    p = df[["prob_class0", "prob_class1"]].to_numpy()
    assert np.isfinite(p).all() and np.abs(p.sum(1) - 1).max() <= 1e-5
