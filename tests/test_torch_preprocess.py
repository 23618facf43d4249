"""The port's preprocess and K1's plain version against the JAX package.

Same seeded uint8 batches through both; the port on the CPU. The K1 kernel
itself runs only on a CUDA card (tests/test_torch_kernels.py)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from wsinsight_tpu.ops import preprocess as jax_pre  # noqa: E402
from wsinsight_tpu.ops.pallas_preprocess import (  # noqa: E402
    make_fused_preprocess_fn as jax_make_fused,
)
from wsinsight_tpu_torch.ops import preprocess as pre  # noqa: E402
from wsinsight_tpu_torch.ops.fused_preprocess import (  # noqa: E402
    fused_preprocess,
    fused_preprocess_reference,
    make_fused_preprocess_fn,
)

MEAN = (0.7238, 0.5716, 0.6779)  # breast-tumor-resnet34.tcga-brca
STD = (0.112, 0.1459, 0.1036)


def _assert_within_one_level(got, want, std=(1.0, 1.0, 1.0)):
    """At most one uint8 level apart (in the output's units, 1 / (255 std[c])),
    on at most 1e-3 of the elements: float32 sums in another order can flip a
    rounding tie. 1e-5 absorbs the affine's last bit."""
    level = 1.0 / (255.0 * np.asarray(std, np.float32))
    diff = np.abs(np.asarray(got, np.float32) - want)
    assert (diff <= level + 1e-5).all()
    assert (diff > 1e-5).mean() <= 1e-3


def _batch(b, h, w=None, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, h, w or h, 3), dtype=np.uint8)


@pytest.mark.parametrize("in_size,out_size", [(350, 224), (175, 224), (96, 64)])
def test_pil_weights_equal_jax(in_size, out_size):
    np.testing.assert_array_equal(
        pre._pil_bilinear_weights(in_size, out_size),
        jax_pre._pil_bilinear_weights(in_size, out_size),
    )


@pytest.mark.parametrize("in_hw,out_hw", [((96, 96), (64, 64)), ((64, 64), (96, 96)), ((97, 83), (64, 48))])
def test_exact_resize_bit_identical_to_jax(in_hw, out_hw):
    x = _batch(3, *in_hw).astype(np.float32)
    want = np.asarray(jax_pre.pil_resize_batch(jnp.asarray(x), out_hw, exact=True))
    got = pre.pil_resize_batch(torch.from_numpy(x), out_hw, exact=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "in_hw,out_hw,max_share",
    [((96, 96), (64, 64), 1e-3), ((97, 83), (64, 48), 1e-3), ((64, 64), (96, 96), 2e-2)],
)
def test_f32_resize_matches_jax(in_hw, out_hw, max_share):
    """<= 1 uint8 level, on a small share of the elements: rounding ties
    flip with the matmul's summation order and FMA use. Upsampling, with
    two taps per output, puts many sums on a tie (about 1.3% at 64 -> 96)."""
    x = _batch(3, *in_hw).astype(np.float32)
    want = np.asarray(jax_pre.pil_resize_batch(jnp.asarray(x), out_hw))
    got = pre.pil_resize_batch(torch.from_numpy(x), out_hw).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= max_share


@pytest.mark.parametrize(
    "spec_kw",
    [
        dict(size=(64, 64), mean=MEAN, std=STD, to_tensor=True),  # exact resize
        dict(size=(64, 64), mean=MEAN, std=STD, to_tensor=True, exact_resize=False),
        dict(size=None, scale=(0.0, 1.0), to_tensor=True),
        dict(size=None, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), to_tensor=True),
    ],
    ids=["resize-exact", "resize-f32", "scale", "no-resize"],
)
def test_make_preprocess_fn_matches_jax(spec_kw):
    x = _batch(2, 96)
    x[1] = 17  # a constant patch takes the Scale guard
    want = np.asarray(jax_pre.make_preprocess_fn(jax_pre.TransformSpec(**spec_kw))(jnp.asarray(x)))
    got = pre.make_preprocess_fn(pre.TransformSpec(**spec_kw))(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_within_one_level(got.numpy(), want, spec_kw.get("std", (1.0, 1.0, 1.0)))


def test_transform_spec_from_config_matches_jax():
    cfg = [
        {"name": "Resize", "arguments": {"size": 224}},
        {"name": "ToTensor"},
        {"name": "Normalize", "arguments": {"mean": list(MEAN), "std": list(STD)}},
    ]
    assert dataclasses.asdict(pre.TransformSpec.from_config(cfg)) == dataclasses.asdict(
        jax_pre.TransformSpec.from_config(cfg)
    )
    with pytest.raises(KeyError):
        pre.TransformSpec.from_config([{"name": "Blur"}])


@pytest.mark.parametrize("in_hw,out_hw", [((96, 96), (64, 64)), ((64, 64), (96, 96)), ((97, 83), (64, 48))])
def test_fused_reference_matches_jax_kernel(in_hw, out_hw):
    """K1's plain version vs the Pallas kernel in interpret mode. Tap-order
    sums against a matmul's: equal at 1e-5 (the JAX kernel test's bar) but
    for rounding ties, which stay within one level."""
    x = _batch(3, *in_hw)
    kw = dict(size=out_hw, mean=MEAN, std=STD, to_tensor=True, exact_resize=False)
    want = np.asarray(jax_make_fused(jax_pre.TransformSpec(**kw))(jnp.asarray(x)))
    fn = make_fused_preprocess_fn(pre.TransformSpec(**kw))
    got = fn(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_within_one_level(got.numpy(), want, STD)


def test_fused_reference_bf16_is_rounded_f32():
    x = torch.from_numpy(_batch(2, 96))
    scale = 1.0 / (255.0 * np.asarray(STD, np.float32))
    shift = -np.asarray(MEAN, np.float32) / np.asarray(STD, np.float32)
    f32 = fused_preprocess_reference(x, (64, 64), scale, shift)
    bf16 = fused_preprocess_reference(x, (64, 64), scale, shift, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, f32.to(torch.bfloat16), rtol=0, atol=0)


def test_make_fused_preprocess_fn_none_where_jax_is():
    for kw in (dict(size=None), dict(size=(8, 8), scale=(0, 1))):
        assert jax_make_fused(jax_pre.TransformSpec(**kw)) is None
        assert make_fused_preprocess_fn(pre.TransformSpec(**kw)) is None


def test_fused_preprocess_cpu_uses_plain_version():
    x = torch.from_numpy(_batch(2, 96))
    before = fused_preprocess.launches
    out = fused_preprocess(x, (64, 64), np.ones(3, np.float32), np.zeros(3, np.float32))
    assert fused_preprocess.launches == before  # no kernel launch on the CPU
    want = pre.pil_resize_batch(x.float(), (64, 64))
    assert (out - want).abs().max() <= 1.0
