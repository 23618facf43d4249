"""The port's host library (``native/``) against the JAX package's, on the CPU.

The same seeded inputs go through each JAX function and its counterpart in
the port: the whole-batch region reader (every codec the writer has, and the
DCT half-scale decode), LZW, the PIL-exact resize, the YUV 4:2:0 packer and
its device inverse, and the stain math. The port's native reader is also held
to its own Python tile path, as tests/test_native_decode.py holds the JAX one.
Then the build: where it lands, that a broken source raises with the
compiler's output, and that a build without libjpeg declines JPEG pages.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _checker_image(side: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 215, size=(side, side, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:side, :side]
    img[(yy // 64 + xx // 64) % 2 == 0] //= 2  # structure so LZW/deflate bite
    return img


def _tone_batch(seed: int, n: int = 8, side: int = 64) -> np.ndarray:
    """H&E tones (and glass) in 8 px blocks with uniform noise of +-17."""
    rng = np.random.default_rng(seed)
    tones = np.array(((176, 98, 168), (214, 132, 186), (150, 80, 160), (226, 160, 200),
                      (236, 236, 236)))
    labels = rng.integers(0, len(tones), (n, side // 8, side // 8))
    img = tones[np.kron(labels, np.ones((1, 8, 8), int))]
    return np.clip(img + rng.integers(-17, 18, img.shape), 0, 255).astype(np.uint8)


def _python_read(slide, location, level, size) -> np.ndarray:
    """Force the port's Python tile path, as tests/test_native_decode.py does."""
    saved = dict(slide._native)
    slide._native = {lvl: False for lvl in range(len(slide._levels))}
    try:
        return slide.read_region_array(location, level, size)
    finally:
        slide._native = saved


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    """{compression: path}: one 768 px checker image, 3 levels, tiles of 256,
    written by the port's writer in every codec it has; LZW (a Python
    encoder, about 30 us a byte) at a third of the size, tiles of 128."""
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    d = tmp_path_factory.mktemp("nativeslides")
    img = _checker_image(768, seed=5)
    out = {}
    for comp in ("none", "deflate", "lzw", "jpeg"):
        out[comp] = d / f"s_{comp}.tif"
        small = comp == "lzw"
        write_pyramidal_tiff(str(out[comp]), img[:256, :256] if small else img,
                             tile=(128, 128) if small else (256, 256), compression=comp,
                             mpp=0.25, levels=3)
    return out


COORDS = np.array([[0, 0], [100, 200], [255, 255], [256, 256], [500, 520], [-40, 700]], np.int64)


def _coords(compression):
    """(coords, patch size) for a slide of ``slides``."""
    return (COORDS // 3, 64) if compression == "lzw" else (COORDS, 200)


@pytest.mark.parametrize("compression,scale", [
    ("none", 1), ("deflate", 1), ("lzw", 1), ("jpeg", 1), ("jpeg", 2),
])
def test_read_patches_array_matches_jax(slides, compression, scale):
    """The port's and the JAX package's native readers (one source, one
    library build each) give the same bytes, level 0 and 1, and count the
    patches as native reads."""
    from wsinsight_tpu.wsi.slide import TpuSlide as JaxSlide
    from wsinsight_tpu_torch.wsi.slide import TpuSlide

    path = str(slides[compression])
    coords, ps = _coords(compression)
    size = (ps // scale, ps // scale)
    with TpuSlide(path) as s, JaxSlide(path) as j:
        for level in (0, 1):
            got = s.read_patches_array(coords, level, size, scale_denom=scale)
            want = j.read_patches_array(coords, level, size, scale_denom=scale)
            assert want is not None and got.shape == (len(coords), *size[::-1], 3)
            np.testing.assert_array_equal(got, want)
        assert s.has_native(0, scale)
        assert s.reads == {"native": 2 * len(coords), "python": 0}


def test_half_scale_declines_lossless_pages(slides):
    from wsinsight_tpu_torch.wsi.slide import TpuSlide

    with TpuSlide(str(slides["deflate"])) as s:
        assert s.has_native(0) and not s.has_native(0, 2)
        assert s.read_patches_array(COORDS, 0, (100, 100), scale_denom=2) is None


@pytest.mark.parametrize("compression", ["none", "deflate", "lzw", "jpeg"])
def test_native_batch_decode_matches_python(slides, compression):
    """Batch decode against the port's Python tile path: identical on the
    lossless codecs, within one level on JPEG (libjpeg against cv2's
    decoder); every read is counted on its path."""
    from wsinsight_tpu_torch.wsi.slide import TpuSlide

    coords, ps = _coords(compression)
    with TpuSlide(str(slides[compression])) as s:
        got = s.read_patches_array(coords, 0, (ps, ps))
        assert got.shape == (len(coords), ps, ps, 3) and got.dtype == np.uint8
        for i, (x, y) in enumerate(coords):
            ref = _python_read(s, (int(x), int(y)), 0, (ps, ps))
            if compression == "jpeg":
                np.testing.assert_allclose(got[i].astype(np.int16), ref.astype(np.int16), atol=1)
            else:
                np.testing.assert_array_equal(got[i], ref)
            np.testing.assert_array_equal(s.read_region_array((int(x), int(y)), 0, (ps, ps)),
                                          got[i])
        assert s.reads == {"native": 2 * len(coords), "python": len(coords)}


def test_native_out_of_bounds_zero_pads(tmp_path):
    from wsinsight_tpu_torch.wsi.slide import TpuSlide
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    path = tmp_path / "oob.tif"
    write_pyramidal_tiff(str(path), _checker_image(512, seed=1), tile=(256, 256),
                         compression="deflate", mpp=0.25)
    with TpuSlide(str(path)) as s:
        coords = np.array([[-50, -60], [400, 400], [600, 600]], np.int64)
        got = s.read_patches_array(coords, 0, (180, 180))
        for i, (x, y) in enumerate(coords):
            np.testing.assert_array_equal(got[i], _python_read(s, (int(x), int(y)), 0, (180, 180)))
        assert got[2].sum() == 0  # fully outside: all zeros


def test_native_pyramid_levels_and_out_buffer(slides):
    from wsinsight_tpu_torch.wsi.slide import TpuSlide

    with TpuSlide(str(slides["deflate"])) as s:
        assert len(s._levels) == 3
        coords = np.array([[0, 0], [512, 512]], np.int64)
        for level in (1, 2):
            got = s.read_patches_array(coords, level, (96, 96))
            for i, (x, y) in enumerate(coords):
                np.testing.assert_array_equal(
                    got[i], _python_read(s, (int(x), int(y)), level, (96, 96)))
        got = s.read_patches_array(coords, 1, (96, 96))
        # out= writes into a caller's slice (the batch-sharding contract)
        buf = np.zeros((4, 96, 96, 3), np.uint8)
        got2 = s.read_patches_array(coords, 1, (96, 96), out=buf[1:3])
        assert got2 is not None and got2.base is buf
        np.testing.assert_array_equal(buf[1:3], got)
        assert buf[0].sum() == 0 and buf[3].sum() == 0
        with pytest.raises(ValueError, match="out must be"):
            s.read_patches_array(coords, 1, (96, 96), out=buf[:1])


def test_native_reader_sparse_zero_bytecount_tiles(tmp_path):
    """Zero-bytecount (sparse) tiles decode as blank, as on the Python path."""
    from wsinsight_tpu_torch.wsi.slide import TpuSlide
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    path = tmp_path / "sparse.tif"
    write_pyramidal_tiff(str(path), _checker_image(512, seed=3), tile=(256, 256),
                         compression="deflate", mpp=0.25)
    with TpuSlide(str(path)) as s:
        # The native reader snapshots offsets/bytecounts when it opens, so
        # mark tile 0 sparse before the first read.
        page = s._levels[0]
        page.offsets[0] = 0
        page.bytecounts[0] = 0
        got = s.read_patches_array(np.array([[10, 10]], np.int64), 0, (100, 100))
        np.testing.assert_array_equal(got[0], _python_read(s, (10, 10), 0, (100, 100)))
        assert got[0].sum() == 0


def test_decode_error_sticks_to_python_and_counts(tmp_path, caplog):
    """A tile the native reader cannot decode: the read returns None, the
    level goes to the Python path for good, a warning is logged, and the
    reads that follow are counted as Python reads."""
    from wsinsight_tpu_torch.wsi.slide import TpuSlide
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    path = tmp_path / "bad.tif"
    write_pyramidal_tiff(str(path), _checker_image(512, seed=4), tile=(256, 256),
                         compression="deflate", mpp=0.25)
    with TpuSlide(str(path)) as s:
        s._levels[0].bytecounts[3] = 7  # tile 3: a truncated deflate stream
        ok = s.read_patches_array(np.array([[0, 0]], np.int64), 0, (64, 64))
        assert ok is not None and s.reads["native"] == 1
        with caplog.at_level("WARNING"):
            assert s.read_patches_array(np.array([[300, 300]], np.int64), 0, (64, 64)) is None
        assert "native decode failed" in caplog.text and not s.has_native(0)
        np.testing.assert_array_equal(s.read_region_array((0, 0), 0, (64, 64)), ok[0])
        assert s.reads == {"native": 1, "python": 1}


def test_lzw_decode_native_matches_jax_and_python():
    from wsinsight_tpu.native import lzw_decode_native as jax_lzw
    from wsinsight_tpu.wsi.tiff import lzw_encode
    from wsinsight_tpu_torch.native import lzw_decode_native
    from wsinsight_tpu_torch.wsi.tiff import lzw_decode

    raw = _checker_image(64, seed=6).tobytes()
    data = lzw_encode(raw)
    got = lzw_decode_native(data, len(raw))
    assert got == raw == jax_lzw(data, len(raw)) == lzw_decode(data, len(raw))
    assert lzw_decode_native(b"\x00\x01\x02", 100) == jax_lzw(b"\x00\x01\x02", 100)


@pytest.mark.parametrize("hw,out_hw,c", [((96, 96), (64, 64), 3), ((350, 350), (224, 224), 3),
                                         ((37, 53), (80, 20), 4), ((64, 64), (64, 64), 1)])
def test_pil_resize_native_matches_jax_and_pil(hw, out_hw, c):
    from PIL import Image

    from wsinsight_tpu.native import _resize_coeffs_i32 as jax_coeffs
    from wsinsight_tpu.native import pil_resize_native as jax_resize
    from wsinsight_tpu_torch.native import _resize_coeffs_i32, pil_resize_native

    src = np.random.default_rng(1).integers(0, 256, (3, *hw, c), dtype=np.uint8)
    got = pil_resize_native(src, out_hw)
    np.testing.assert_array_equal(got, jax_resize(src, out_hw))
    np.testing.assert_array_equal(_resize_coeffs_i32(hw[0], out_hw[0]), jax_coeffs(hw[0], out_hw[0]))
    if c in (1, 3):
        mode = "L" if c == 1 else "RGB"
        pil = np.stack([np.asarray(Image.fromarray(im.squeeze(-1) if c == 1 else im, mode)
                                   .resize(out_hw[::-1], Image.BILINEAR)) for im in src])
        np.testing.assert_array_equal(got, pil.reshape(got.shape))
    out = np.empty_like(got[:1])
    assert pil_resize_native(src[:1], out_hw, out=out) is out
    np.testing.assert_array_equal(out[0], got[0])
    np.testing.assert_array_equal(pil_resize_native(src[0], out_hw), got[0])
    assert pil_resize_native(src.astype(np.float32), out_hw) is None


def test_rgb_to_yuv420_matches_jax_and_numpy():
    import wsinsight_tpu.native as jax_native
    from wsinsight_tpu_torch.native import rgb_to_yuv420, rgb_to_yuv420_numpy

    rng = np.random.default_rng(2)
    batch = rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    batch[0] = 0
    batch[1] = 255
    got = rgb_to_yuv420(batch)
    assert got.shape == (3, 72, 64) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, rgb_to_yuv420_numpy(batch))
    np.testing.assert_array_equal(got, jax_native.rgb_to_yuv420(batch))
    lib, tried = jax_native._lib, jax_native._tried
    try:  # the JAX package's numpy fallback
        jax_native._lib, jax_native._tried = None, True
        np.testing.assert_array_equal(got, jax_native.rgb_to_yuv420(batch))
    finally:
        jax_native._lib, jax_native._tried = lib, tried
    np.testing.assert_array_equal(rgb_to_yuv420(batch[2]), got[2])
    for bad in (np.zeros((1, 47, 64, 3), np.uint8), np.zeros((1, 48, 64, 4), np.uint8)):
        assert rgb_to_yuv420(bad) is None and rgb_to_yuv420_numpy(bad) is None


@pytest.mark.parametrize("kind", ["noise", "tones"])
def test_yuv420_to_rgb_matches_jax(kind):
    import jax.numpy as jnp

    from wsinsight_tpu.ops.preprocess import yuv420_to_rgb as jax_yuv420_to_rgb
    from wsinsight_tpu_torch.native import rgb_to_yuv420
    from wsinsight_tpu_torch.ops.preprocess import yuv420_to_rgb

    rgb = (np.random.default_rng(3).integers(0, 256, (4, 96, 64, 3), dtype=np.uint8)
           if kind == "noise" else _tone_batch(3, n=4))
    packed = rgb_to_yuv420(rgb)
    got = yuv420_to_rgb(torch.from_numpy(packed))
    want = np.asarray(jax_yuv420_to_rgb(jnp.asarray(packed)))
    assert got.dtype == torch.float32 and got.shape == rgb.shape
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    if kind == "tones":  # near-lossless on H&E-like colour fields
        assert np.abs(got.numpy() - rgb).mean() < 12


# ---------------------------------------------------------------------------
# Stain math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed", [("tones", 0), ("tones", 1), ("noise", 0), ("noise", 1)])
def test_estimate_stains_matches_jax(kind, seed):
    from wsinsight_tpu.ops.stain import estimate_stains_from_batch as jax_estimate
    from wsinsight_tpu_torch.ops.stain import estimate_stains_from_batch

    batch = (_tone_batch(seed) if kind == "tones"
             else np.random.default_rng(seed).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    got = estimate_stains_from_batch(batch)
    assert got.shape == (3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_estimate(batch), rtol=0, atol=1e-4)


def test_eigenvector_sign_changes_jax_stains(monkeypatch):
    """The Macenko angles depend on the eigenvectors' signs: flipping the
    second eigenvector (the JAX code takes eigh's as they come) moves the
    JAX stain matrix far on a noise batch, while H&E tones barely move. So
    the port takes its 3x3 eigh from the host's LAPACK whatever the tensors'
    device (the card's solver may choose other signs); on the CPU those are
    the signs JAX's eigh returns (test_estimate_stains_matches_jax holds the
    stain matrices within 1e-4)."""
    import jax.numpy as jnp

    from wsinsight_tpu.ops import stain as jax_stain

    eigh = jnp.linalg.eigh

    def flipped(c):
        e, v = eigh(c)
        return e, v * jnp.asarray([1.0, -1.0, 1.0])

    noise = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    moved = {}
    for kind, batch in (("noise", noise), ("tones", _tone_batch(0))):
        base = jax_stain.estimate_stains_from_batch(batch)
        monkeypatch.setattr(jnp.linalg, "eigh", flipped)
        moved[kind] = float(np.abs(jax_stain.estimate_stains_from_batch(batch) - base).max())
        monkeypatch.setattr(jnp.linalg, "eigh", eigh)
    assert moved["noise"] > 0.5 and moved["tones"] < 1e-5


def test_stain_normalization_matches_jax():
    """The normalized, rounded uint8 image: port vs JAX within one level on a
    share <= 1e-3 (log/exp of two libraries); identity on the target stains."""
    import jax.numpy as jnp

    from wsinsight_tpu.ops import stain as jax_stain
    from wsinsight_tpu_torch.ops import stain

    batch = _tone_batch(4, n=4)
    w_est = stain.estimate_stains_from_batch(batch)
    w_def = stain.default_target_stains()
    np.testing.assert_array_equal(w_def, jax_stain.default_target_stains())
    x = torch.from_numpy(batch.astype(np.float32)) + stain.EPSILON
    got = stain.deconvolution_based_normalization(x, torch.from_numpy(w_est),
                                                  torch.from_numpy(w_def))
    got = torch.clamp(torch.round(got), 0, 255).numpy()
    want = jax_stain.deconvolution_based_normalization(
        jnp.asarray(batch, jnp.float32) + jax_stain.EPSILON, jnp.asarray(w_est), jnp.asarray(w_def))
    want = np.asarray(jnp.clip(jnp.round(want), 0, 255))
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert np.abs(got - batch).mean() > 1  # the stains did change
    same = stain.deconvolution_based_normalization(x, torch.from_numpy(w_def),
                                                   torch.from_numpy(w_def))
    assert float((same - x).abs().max()) < 0.05
    sda = stain.rgb_to_sda(x)
    np.testing.assert_allclose(stain.sda_to_rgb(sda).numpy(), x.numpy(), rtol=1e-5)
    np.testing.assert_allclose(sda.numpy(), np.asarray(jax_stain.rgb_to_sda(jnp.asarray(x.numpy()))),
                               rtol=1e-5, atol=1e-4)


def test_complement_stain_matrix_matches_jax():
    from wsinsight_tpu.ops.stain import complement_stain_matrix as jax_complement
    from wsinsight_tpu_torch.ops.stain import complement_stain_matrix

    w = np.array([[0.65, 0.07, 0.0], [0.70, 0.99, 0.0], [0.29, 0.11, 0.0]], np.float32)
    np.testing.assert_array_equal(complement_stain_matrix(w), jax_complement(w))


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def test_build_lands_in_build_dir_and_reports_jpeg():
    from pathlib import Path

    import wsinsight_tpu_torch
    from wsinsight_tpu_torch import native
    from wsinsight_tpu_torch.ops import native_build

    lib = native.get_lib()
    path = native_build.library_path()
    root = Path(wsinsight_tpu_torch.__file__).resolve().parents[1]
    assert path.parent == root / "build" / "wsinsight_tpu_torch" and path.exists()
    assert path.name.startswith("libwsinsight_native-") and path.suffix == ".so"
    assert native.has_jpeg() == native_build.jpeg_available()
    assert ("-ljpeg" in native_build.command(path)) == native_build.jpeg_available()
    assert lib is native.get_lib()


def test_bad_source_raises_with_compiler_output(tmp_path, monkeypatch):
    from wsinsight_tpu_torch.ops import cuda_build, native_build

    src = tmp_path / "src"
    src.mkdir()
    for name in native_build.NATIVE_SOURCES:
        (src / name).write_text("int broken( {\n" if name == "yuv.cpp" else "\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on native:[\s\S]*yuv\.cpp[\s\S]*error"):
        native_build.build()
    assert not list((tmp_path / "build").iterdir())  # no library, no temporary left


def test_build_without_libjpeg_declines_jpeg_pages(slides, tmp_path, monkeypatch):
    """Where the probe finds no libjpeg, the library is built with
    -DWSI_NO_JPEG: JPEG pages decode through the Python tile path (counted),
    lossless pages stay native."""
    from wsinsight_tpu_torch import native
    from wsinsight_tpu_torch.ops import cuda_build, native_build
    from wsinsight_tpu_torch.wsi.slide import TpuSlide

    monkeypatch.setattr(native_build, "jpeg_available", lambda: False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    command = native_build.command("x.so")
    assert "-DWSI_NO_JPEG" in command and "-ljpeg" not in command
    native_build.build()
    lib = native._bind(ctypes.CDLL(str(native_build.library_path())))
    assert lib.wsi_has_jpeg() == 0
    monkeypatch.setattr(native, "_lib", lib)
    with TpuSlide(str(slides["jpeg"])) as s:
        assert not s.has_native(0) and not s.has_native(0, 2)
        assert s.read_patches_array(COORDS, 0, (64, 64)) is None
        s.read_region_array((10, 10), 0, (64, 64))
        assert s.reads == {"native": 0, "python": 1}
    with TpuSlide(str(slides["deflate"])) as s:
        assert s.read_patches_array(COORDS, 0, (64, 64)) is not None
        assert s.reads == {"native": len(COORDS), "python": 0}
