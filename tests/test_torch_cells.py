"""The port's CellViT cell path (model, weights, stitcher device half,
CellEngine) against the JAX package.

Same inputs through both: arrays made by numpy from a seed, flax params
carried into torch by ``flax_params_to_state_dict``, or one JAX-authored
msgpack checkpoint loaded by both engines. The port runs on the CPU, where
K2's wrapper runs its plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_attention import flax_init_random  # noqa: E402
from wsinsight_tpu.engine.cells import CellEngine as JaxCellEngine  # noqa: E402
from wsinsight_tpu.engine.stitch import TileRemapStitcher as JaxStitcher  # noqa: E402
from wsinsight_tpu.engine.stitch import make_map_postprocess as jax_postprocess  # noqa: E402
from wsinsight_tpu.models.cellvit import CellViT as FlaxCellViT  # noqa: E402
from wsinsight_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from wsinsight_tpu.zoo import load_local_model as jax_load_local  # noqa: E402
from wsinsight_tpu.zoo import make_random_local_model as jax_make_random  # noqa: E402
from wsinsight_tpu_torch.engine import CellEngine, TileRemapStitcher, make_map_postprocess  # noqa: E402
from wsinsight_tpu_torch.models import create_model  # noqa: E402
from wsinsight_tpu_torch.models.cellvit import CellViT  # noqa: E402
from wsinsight_tpu_torch.models.convert import flax_params_to_state_dict  # noqa: E402
from wsinsight_tpu_torch.models.layers import ConvTranspose  # noqa: E402
from wsinsight_tpu_torch.models.vit import ViTConfig  # noqa: E402
from wsinsight_tpu_torch.zoo import load_local_model, make_random_local_model  # noqa: E402

MAPS = ("nuclei_binary_map", "hv_map", "nuclei_type_map")

# Small encoders at 64 px (a 4x4 token grid): a cls-token ViT (the ViT-256
# decoder widths) and a SAM with embed 512 (the SAM decoder widths), 3x3
# windows over a grid padded to 6x6, two global blocks.
SMALL = {
    "vit_cls": dict(embed_dim=96, depth=4, num_heads=2, window_size=0, use_rel_pos=False,
                    use_cls_token=True, extract_layers=(1, 2, 3, 4),
                    mlp_naming=("mlp.fc1", "mlp.fc2")),
    "sam_512": dict(embed_dim=512, depth=4, num_heads=8, window_size=3, use_rel_pos=True,
                    use_cls_token=False, global_attn_indexes=(1, 3),
                    extract_layers=(1, 2, 3, 4), mlp_ratio=1.0),
}


@pytest.fixture(scope="module")
def jax_cell_model(tmp_path_factory):
    """One JAX-authored CellViT-256 checkpoint (flax init, seed 0), 128 px."""
    return jax_make_random("cellvit-256", 6, tmp_path_factory.mktemp("cellvit256"),
                           patch_size_pixels=128)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_cellvit_matches_flax(name):
    kw = SMALL[name]
    flax_m = FlaxCellViT(variant="sam-b", num_nuclei_classes=3, halo_size=8,
                         config_override=JaxViTConfig(**kw))
    params = flax_init_random(flax_m, (1, 64, 64, 3), seed=1)
    x = (np.random.default_rng(2).standard_normal((2, 64, 64, 3)) * 0.5).astype(np.float32)
    want = jax.jit(flax_m.apply)({"params": params}, jnp.asarray(x))

    model = CellViT(variant="sam-b", num_nuclei_classes=3, halo_size=8,
                    config_override=ViTConfig(**kw), img_size=64).eval()
    model.load_state_dict(flax_params_to_state_dict(params, model), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in (*MAPS, "tissue_types"):
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-3,
                                   rtol=1e-4, err_msg=key)
    assert got["nuclei_type_map"].shape == (2, 3, 48, 48)


@pytest.mark.parametrize("in_ch,out_ch", [(3, 5), (4, 4)])
def test_deconv_flip_matches_flax(in_ch, out_ch):
    """flax ConvTranspose kernel (kh, kw, in, out) -> torch (in, out, kh, kw)
    with the spatial flip; chosen by the module's type, so in == out (where
    a conv's weight has the same shape) converts the same way."""
    import flax.linen as nn

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.ConvTranspose(out_ch, (2, 2), strides=(2, 2), padding="VALID",
                                    name="deconv")(x)

    x = np.random.default_rng(0).standard_normal((1, 8, 8, in_ch)).astype(np.float32)
    params = flax_init_random(M(), x.shape, seed=3)
    want = np.asarray(M().apply({"params": params}, jnp.asarray(x)))

    model = torch.nn.Module()
    model.deconv = ConvTranspose(in_ch, out_ch)
    model.load_state_dict(flax_params_to_state_dict(params, model), strict=True)
    with torch.no_grad():
        got = model.deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _logits(seed=0, b=2, h=164, k=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 2, h, h)).astype(np.float32) * 2,
            rng.standard_normal((b, 2, h, h)).astype(np.float32),
            rng.standard_normal((b, k, h, h)).astype(np.float32) * 2)


# slide patch size S for the model's 164 px maps: x40 on an x20 slide
# (0.5 um/px: shrink), same scale, and an x80 slide (grow).
SIZES = [(82, 0.5), (164, 0.25), (328, 0.125)]


@pytest.mark.parametrize("s,slide_mpp", SIZES)
def test_map_postprocess_matches_jax(s, slide_mpp):
    logits = _logits()
    want = jax_postprocess(s, 0.25 / slide_mpp)(*map(jnp.asarray, logits))
    got = make_map_postprocess(s, 0.25 / slide_mpp)(*map(torch.from_numpy, logits))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def _stitchers(s, slide_mpp, transfer):
    kw = dict(n_classes=6, slide_width=2 * s + 40, slide_height=s + 40, slide_patch_size=s,
              slide_halo_size=23, slide_mpp=slide_mpp, model_mpp=0.25, transfer_dtype=transfer)
    return JaxStitcher(**kw), TileRemapStitcher(**kw)


def _assert_transferred(got, want, kind, what, want_f32=None):
    """float32: 1e-6. bfloat16: at most one bf16 ulp, on a share <= 1e-3 of
    the values (f32 values that differ by rounding can round apart). uint8:
    at most one level, on rounding ties of the f32 values only."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    if kind == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=what)
    elif kind == "bfloat16":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0**-7, err_msg=what)
        assert np.mean(diff > 0) <= 1e-3, what
    else:
        assert diff.max() <= 1, what
        tie = np.abs(np.asarray(want_f32) * 255.0 % 1.0 - 0.5) < 1e-3
        assert np.all(tie[diff > 0]), what


@pytest.mark.parametrize("transfer", ["quantized", "bfloat16", "float32"])
@pytest.mark.parametrize("s,slide_mpp", SIZES)
def test_device_postprocess_and_scatter_match_jax(s, slide_mpp, transfer):
    logits = _logits(seed=1)
    jst, tst = _stitchers(s, slide_mpp, transfer)
    pred = dict(zip(MAPS, logits))
    want = jst.device_postprocess({k: jnp.asarray(v) for k, v in pred.items()})
    got = tst.device_postprocess({k: torch.from_numpy(v) for k, v in pred.items()})
    want_f32 = jax_postprocess(s, 0.25 / slide_mpp)(*map(jnp.asarray, logits))
    kinds = {"quantized": ("uint8", "bfloat16", "uint8")}.get(transfer, (transfer,) * 3)
    for i, name in enumerate(("np", "hv", "tp")):
        assert str(got[i].dtype) == f"torch.{kinds[i]}", name
        _assert_transferred(got[i].float().numpy(), np.asarray(want[i]).astype(np.float32),
                            kinds[i], name, np.asarray(want_f32[i]))
    coords = np.array([[-23, -23, 0, 0], [s - 23, -23, 0, 0]])
    jst.scatter(want, coords, 2)
    tst.scatter(got, coords, 2)
    for i, name in enumerate(("np_map", "hv_map", "tp_map")):
        g, w = getattr(tst, name), getattr(jst, name)
        if kinds[i] == "uint8":  # dequantized: one level is 1/255
            assert np.abs(g - w).max() <= 1 / 255 + 1e-7, name
        else:
            _assert_transferred(g, w, kinds[i], name)
    # finalize runs on the scattered canvases: the JAX finalize on the same
    # canvases finds the same instances
    for i, name in enumerate(("np_map", "hv_map", "tp_map")):
        getattr(jst, name)[:] = getattr(tst, name)
    got, want = tst.finalize(num_workers=1), jst.finalize(num_workers=1)
    assert len(got[0]) == len(got[1]) == len(got[2]) == len(want[0])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_cell_engine_matches_jax(jax_cell_model):
    """The port's CellEngine on the CPU and the JAX CellEngine load the same
    JAX msgpack and map the same uint8 patches (parity mode)."""
    cfg, weights = jax_cell_model
    x = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = JaxCellEngine(jax_load_local(cfg, weights), max_devices=1).run_batch(x)
    engine = CellEngine(load_local_model(cfg, weights), device="cpu")
    assert engine.pad_batch(3) == 3
    got = engine.run_batch(x)
    for key in (*MAPS, "tissue_types"):
        assert got[key].shape == np.asarray(want[key]).shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-3,
                                   rtol=1e-4, err_msg=key)
    # the maps of a flax-initialised CellViT-256 are not degenerate
    assert float(got["nuclei_binary_map"].std()) > 1e-3


def test_cell_engine_bf16_close_to_parity(tmp_path):
    """mixed_precision (bf16 autocast) vs parity on the port's own seeded
    model: NP decisions agree on almost every pixel."""
    cfg, weights = make_random_local_model("cellvit-256", 6, tmp_path, patch_size_pixels=128)
    x = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    handle = load_local_model(cfg, weights)
    p32 = CellEngine(handle, device="cpu").run_batch(x)
    p16 = CellEngine(handle, mixed_precision=True, device="cpu").run_batch(x)
    np32 = torch.softmax(p32["nuclei_binary_map"], 1)[:, 1] > 0.5
    np16 = torch.softmax(p16["nuclei_binary_map"], 1)[:, 1] > 0.5
    assert float((np32 == np16).float().mean()) >= 0.99
    for key in MAPS:
        assert bool(torch.isfinite(p16[key]).all()), key


def test_cell_engine_bf16_matches_jax_bf16(jax_cell_model):
    """The port's bf16 CellEngine on the CPU against JAX's bf16 CellEngine,
    one JAX-authored checkpoint and the same uint8 patches: NP > 0.5
    decisions agree on >= 99% of pixels (the cell path's bf16 bar). The two
    round in other places (JAX's default attention rounds the scores to bf16,
    K2 keeps them in f32), so the maps differ by more than parity's 1e-3."""
    cfg, weights = jax_cell_model
    x = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = JaxCellEngine(jax_load_local(cfg, weights), mixed_precision=True,
                         max_devices=1).run_batch(x)
    got = CellEngine(load_local_model(cfg, weights), mixed_precision=True,
                     device="cpu").run_batch(x)
    want = {k: np.asarray(want[k], np.float32) for k in MAPS}
    got = {k: got[k].float().numpy() for k in MAPS}
    for key in MAPS:
        assert got[key].shape == want[key].shape and np.isfinite(got[key]).all(), key

    def softmax(a):
        e = np.exp(a - a.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    np_agree = float(np.mean((softmax(got["nuclei_binary_map"])[:, 1] > 0.5)
                             == (softmax(want["nuclei_binary_map"])[:, 1] > 0.5)))
    tp_agree = float(np.mean(got["nuclei_type_map"].argmax(1) == want["nuclei_type_map"].argmax(1)))
    drift = {k: float(np.abs(got[k] - want[k]).max()) for k in MAPS}
    print(f"bf16 port vs JAX: NP > 0.5 agrees on {np_agree:.4%}, TP argmax on {tp_agree:.4%};"
          f" max |d| {drift}")
    assert np_agree >= 0.99


def test_random_cell_model_config_matches_jax(tmp_path, jax_cell_model):
    cfg, weights = make_random_local_model("cellvit-256", 6, tmp_path / "a", patch_size_pixels=128)
    assert load_local_model(cfg, weights).config.to_dict() == \
        jax_load_local(*jax_cell_model).config.to_dict()
    again = make_random_local_model("cellvit-256", 6, tmp_path / "b", patch_size_pixels=128)
    a = load_local_model(cfg, weights).load_state_dict()
    b = load_local_model(*again).load_state_dict()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # seeded, with the heads scaled to unit-scale maps
    model = create_model("cellvit-256", 6, halo_size=46, img_size=128)
    model.load_state_dict(a, strict=True)
    x = torch.randn((2, 128, 128, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        std = float(model(x)["nuclei_binary_map"].std())
    assert 0.3 < std < 3.0


def test_engine_init_random_is_seeded():
    from wsinsight_tpu_torch.zoo import ModelConfiguration, ModelHandle

    cfg = ModelConfiguration.from_dict({
        "architecture": "cellvit-256", "num_classes": 3, "class_names": ["a", "b", "c"],
        "patch_size_pixels": 96, "spacing_um_px": 0.25, "halo_size_pixels": 16,
        "transform": [{"name": "ToTensor"}],
    })
    handle = ModelHandle(name="random", config=cfg)
    a, b = (CellEngine(handle, init_random=True, device="cpu", seed=s) for s in (0, 0))
    c = CellEngine(handle, init_random=True, device="cpu", seed=1)
    sa, sb, sc = (e.model.state_dict() for e in (a, b, c))
    torch.testing.assert_close(sa, sb, rtol=0, atol=0)
    assert not torch.equal(sa["encoder.pos_embed"], sc["encoder.pos_embed"])
    assert a.run_batch(np.zeros((1, 96, 96, 3), np.uint8))["hv_map"].shape == (1, 2, 64, 64)


def test_cell_engine_takes_the_yuv_wire(monkeypatch, jax_cell_model):
    """WSINSIGHT_WIRE=yuv420: the cell path's sources ship (B, P*3/2, P)
    planar YUV 4:2:0 and the engine rebuilds RGB on its device; its maps are
    those of the RGB wire on the rebuilt patches."""
    from wsinsight_tpu_torch.engine.cells import _cell_wire
    from wsinsight_tpu_torch.native import rgb_to_yuv420
    from wsinsight_tpu_torch.ops.preprocess import yuv420_to_rgb

    monkeypatch.setenv("WSINSIGHT_WIRE", "yuv420")
    assert _cell_wire() == "yuv420"
    engine = CellEngine(load_local_model(*jax_cell_model), device="cpu")
    x = np.random.default_rng(3).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    packed = rgb_to_yuv420(x)
    assert packed.shape == (2, 192, 128)
    rebuilt = yuv420_to_rgb(torch.from_numpy(packed)).to(torch.uint8).numpy()
    got, want = engine.run_batch(packed), engine.run_batch(rebuilt)
    for key in (*MAPS, "tissue_types"):
        assert torch.equal(got[key], want[key]), key
    monkeypatch.setenv("WSINSIGHT_WIRE", "rgb")
    assert _cell_wire() is None


@pytest.mark.parametrize("var,value", [("WSINSIGHT_PRECISION", "high")])
def test_cell_engine_refuses_unported_options(monkeypatch, jax_cell_model, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        CellEngine(load_local_model(*jax_cell_model), device="cpu")


def test_virchow_and_foundation_raise():
    from wsinsight_tpu_torch.models.vit import HOPTIMUS_VIT_G, FoundationViT

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("cellvit-virchow", 6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FoundationViT(HOPTIMUS_VIT_G)
