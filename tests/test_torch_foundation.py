"""The port's DINOv2 ViT (Virchow's encoder, H-Optimus-0's FoundationViT),
CellViT-Virchow and the H-Optimus extractor against the JAX package.

Small configs with the real feature set (SwiGLU, LayerScale, native-grid
pos-embed, register tokens), inputs from a numpy seed, flax params carried
into torch by ``flax_params_to_state_dict``. The port runs on the CPU, where
K2's wrapper runs its plain version. Float32 is held within atol 1e-4 and
rtol 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_attention import flax_init_random  # noqa: E402
from wsinsight_tpu.models.cellvit import CellViT as FlaxCellViT  # noqa: E402
from wsinsight_tpu.models.vit import FoundationViT as FlaxFoundationViT  # noqa: E402
from wsinsight_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from wsinsight_tpu_torch.models.cellvit import CellViT  # noqa: E402
from wsinsight_tpu_torch.models.convert import flax_params_to_state_dict  # noqa: E402
from wsinsight_tpu_torch.models.vit import FoundationViT, ViTConfig, resample_pos_grid  # noqa: E402
from wsinsight_tpu_torch.ops.resize import cubic_resize_weights, resize_axis  # noqa: E402

ATOL = RTOL = 1e-4
MAPS = ("nuclei_binary_map", "hv_map", "nuclei_type_map", "tissue_types")

# the H-Optimus-0 feature set at width 64 (SwiGLU hidden int(64 * 4096/1536))
FOUNDATION = dict(embed_dim=64, depth=3, num_heads=4, patch_size=14, mlp_ratio=4096 / 1536,
                  window_size=0, use_rel_pos=False, use_cls_token=True,
                  mlp_naming=("mlp.fc1", "mlp.fc2"), mlp_type="swiglu", layer_scale=True,
                  native_grid=8, reg_tokens=4, no_embed_class=True)
# Virchow's at width 64 (SwiGLU hidden int(64 * 5.3375) = 341), native grid 8
VIRCHOW = dict(embed_dim=64, depth=4, num_heads=4, patch_size=14, mlp_ratio=5.3375,
               window_size=0, use_rel_pos=False, use_cls_token=True, extract_layers=(1, 2, 3, 4),
               mlp_naming=("mlp.fc1", "mlp.fc2"), mlp_type="swiglu", layer_scale=True,
               native_grid=8)


def _with_gains(params, seed):
    """LayerScale gains drawn in [0.1, 1]: flax's 1e-5 init would leave every
    block near the identity and the comparison would test little."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
                     if k in ("ls1.gamma", "ls2.gamma") else v))
                for k, v in tree.items()}

    return walk(params)


def _images(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("size,no_embed_class", [(112, True), (168, True), (168, False)])
def test_foundation_vit_matches_flax(size, no_embed_class):
    """Registers and the patch-only pos-embed, or (without registers, as
    timm pairs them) a pos-embed over the cls token too; the native grid of
    8 and a runtime grid of 12 (the pos-embed resampled)."""
    kw = dict(FOUNDATION, no_embed_class=no_embed_class,
              reg_tokens=FOUNDATION["reg_tokens"] if no_embed_class else 0)
    flax_m = FlaxFoundationViT(JaxViTConfig(**kw))
    params = _with_gains(flax_init_random(flax_m, (1, size, size, 3), seed=1), seed=2)
    x = _images((2, size, size, 3), seed=3)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(flax_m.apply({"params": params}, jnp.asarray(x)))

    model = FoundationViT(ViTConfig(**kw), img_size=size).eval()
    model.load_state_dict(flax_params_to_state_dict(params, model), strict=True)
    assert model.pos_embed.shape == (1, 64 + (0 if no_embed_class else 1), 64)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cellvit_virchow_matches_flax():
    """CellViT with a small Virchow encoder at halo 8: at 112 px the /14
    grid is the native 8 and its skips are resized to the /16 grid of 7; at
    128 px the grid of 9 resamples the pos-embed and its skips shrink to 8."""
    for size in (112, 128):
        flax_m = FlaxCellViT(variant="virchow", num_nuclei_classes=3, halo_size=8,
                             config_override=JaxViTConfig(**VIRCHOW))
        params = _with_gains(flax_init_random(flax_m, (1, size, size, 3), seed=4), seed=5)
        x = _images((2, size, size, 3), seed=6)
        with jax.default_matmul_precision("float32"):
            want = jax.jit(flax_m.apply)({"params": params}, jnp.asarray(x))

        model = CellViT(variant="virchow", num_nuclei_classes=3, halo_size=8,
                        config_override=ViTConfig(**VIRCHOW), img_size=size).eval()
        model.load_state_dict(flax_params_to_state_dict(params, model), strict=True)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        for key in MAPS:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{size} {key}")
        assert got["nuclei_binary_map"].shape == (2, 2, size - 16, size - 16)


@pytest.mark.parametrize("ng,gh,gw", [(16, 18, 18), (16, 12, 20), (8, 8, 8)])
def test_pos_embed_resample_matches_jax(ng, gh, gw):
    grid = _images((1, ng * ng, 32), seed=7)
    want = jax.image.resize(jnp.asarray(grid).reshape(1, ng, ng, 32), (1, gh, gw, 32),
                            method="bilinear").reshape(1, gh * gw, 32)
    got = resample_pos_grid(torch.from_numpy(grid), ng, gh, gw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("in_size,out_size", [(112, 224), (300, 224), (18, 16), (16, 18)])
def test_cubic_resize_weights_match_jax(in_size, out_size):
    """Keys' cubic, a = -0.5, antialiased when shrinking: the weights, and an
    image resized along both axes, against ``jax.image.resize(..., "bicubic")``."""
    eye = np.eye(in_size, dtype=np.float32)[None, :, :, None]
    want_w = np.asarray(jax.image.resize(jnp.asarray(eye), (1, out_size, in_size, 1),
                                         method="bicubic"))[0, :, :, 0]
    np.testing.assert_allclose(cubic_resize_weights(in_size, out_size), want_w, atol=ATOL)
    img = np.random.default_rng(8).random((2, in_size, in_size, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (2, out_size, out_size, 3), method="bicubic")
    t = torch.from_numpy(img)
    got = resize_axis(resize_axis(t, 1, out_size, "cubic"), 2, out_size, "cubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def tiny_hoptimus():
    """A small H-Optimus config (width 32, 2 blocks, native grid 16) with
    seeded flax params, as the JAX package's extractor test builds it."""
    cfg = dict(FOUNDATION, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, native_grid=16)
    params = _with_gains(flax_init_random(FlaxFoundationViT(JaxViTConfig(**cfg)),
                                          (1, 224, 224, 3), seed=9), seed=10)
    return cfg, params


@pytest.mark.parametrize("size", [224, 112])
def test_hoptimus_extractor_matches_flax(monkeypatch, tiny_hoptimus, size):
    """The port's extractor (``vit_hoptimus_extractor``) against
    ``flax_hoptimus_extractor`` on the same uint8 crops: ragged batches
    padded, 224 px as it is and 112 px crops through the bicubic resize."""
    import wsinsight_tpu.models.vit as jax_vit
    import wsinsight_tpu_torch.insightlib.foundation as foundation
    import wsinsight_tpu_torch.models.vit as vit
    from wsinsight_tpu.insightlib.foundation import flax_hoptimus_extractor

    cfg, params = tiny_hoptimus
    monkeypatch.setattr(jax_vit, "HOPTIMUS_VIT_G", JaxViTConfig(**cfg))
    monkeypatch.setattr(vit, "HOPTIMUS_VIT_G", ViTConfig(**cfg))
    crops = np.random.default_rng(11).integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    with jax.default_matmul_precision("float32"):
        want = flax_hoptimus_extractor(params=params, batch_size=4, mixed_precision=False)(crops)
    ex = foundation.vit_hoptimus_extractor(params=params, batch_size=4, mixed_precision=False,
                                           device="cpu")
    got = ex(crops)
    assert got.shape == (6, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
