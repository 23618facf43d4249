"""The port's attention (K2's plain version, rel-pos, Attention, Block)
against the JAX package.

Same inputs through both: arrays made by numpy from a seed; flax params (the
flax module's ``init`` tree under ``jax.eval_shape``, filled from numpy)
carried into torch by ``flax_params_to_state_dict``. The JAX kernel runs in
interpret mode, as its own tests run it on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from wsinsight_tpu.models import vit as jvit  # noqa: E402
from wsinsight_tpu.ops.flash_attn import window_attention as jax_window_attention  # noqa: E402
from wsinsight_tpu_torch.models.convert import flax_params_to_state_dict  # noqa: E402
from wsinsight_tpu_torch.models.layers import compute_in  # noqa: E402
from wsinsight_tpu_torch.models.vit import Attention, Block, _get_rel_pos  # noqa: E402
from wsinsight_tpu_torch.ops.flash_attn import (  # noqa: E402
    window_attention,
    window_attention_reference,
)
from wsinsight_tpu_torch.ops.resize import linear_resize_weights  # noqa: E402


def random_flax_tree(tree, seed: int = 0):
    """Fill a flax param tree of shapes (any nesting) with seeded numpy
    values: kernels normal with He/LeCun variance, norm scales and batch-norm
    weights/variances positive, everything else (biases, means, pos/cls
    embeddings, rel-pos tables) N(0, 0.1^2) or, for rel-pos, N(0, 0.5^2) so
    that it moves the scores."""
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for name, leaf in node.items():
            if hasattr(leaf, "items"):
                out[name] = fill(leaf)
                continue
            shape = leaf.shape
            if name == "kernel":
                gain = 2.0 if len(shape) == 4 else 1.0
                value = rng.standard_normal(shape) * np.sqrt(gain / np.prod(shape[:-1]))
            elif name in ("scale", "weight", "running_var"):
                value = rng.random(shape) + 0.5
            elif name.startswith("rel_pos"):
                value = rng.standard_normal(shape) * 0.5
            else:
                value = rng.standard_normal(shape) * 0.1
            out[name] = value.astype(np.float32)
        return out

    return fill(tree)


def flax_init_random(module, x_shape, seed: int = 0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32))
    return random_flax_tree(shapes["params"], seed)


def _toeplitz(table, size):
    idx = np.add.outer(np.arange(size), -np.arange(size)) + size - 1
    return table[idx]


# (name, batch, grid HP x WP, heads, head dim, window, with rel-pos)
ATTN_CASES = [
    ("windowed_rel", 2, (6, 6), 2, 16, 3, True),
    ("windowed", 2, (6, 6), 2, 16, 3, False),
    ("global_rel", 2, (4, 5), 2, 16, 0, True),
    ("ragged_cls_row", 2, (1, 9), 3, 8, 0, False),
]
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (5e-2, 5e-2)}


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_jax_kernel(case, dtype):
    _, b, (hp, wp), heads, hd, window, rel = case
    rng = np.random.default_rng(0)
    dim = heads * hd
    qkv = rng.standard_normal((b, hp, wp, 3 * dim)).astype(np.float32)
    rh = rw = None
    if rel:
        ah, aw = (window, window) if window else (hp, wp)
        rh = _toeplitz(rng.standard_normal((2 * ah - 1, hd)).astype(np.float32) * 0.5, ah)
        rw = _toeplitz(rng.standard_normal((2 * aw - 1, hd)).astype(np.float32) * 0.5, aw)
    scale = hd**-0.5
    jdt = jnp.dtype(dtype)
    want = jax_window_attention(
        jnp.asarray(qkv, jdt), heads, window, scale,
        None if rh is None else jnp.asarray(rh, jdt), None if rw is None else jnp.asarray(rw, jdt),
        interpret=True,
    )
    tdt = getattr(torch, dtype)
    got = window_attention_reference(
        torch.from_numpy(qkv).to(tdt), heads, window, scale,
        None if rh is None else torch.from_numpy(rh).to(tdt),
        None if rw is None else torch.from_numpy(rw).to(tdt),
    )
    assert got.dtype == tdt and got.shape == (b, hp, wp, dim)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# (name, grid HP x WP, heads, head dim, window, valid (h, w), with rel-pos):
# SAM-style padded windows whose real rows the kernel alone computes. The
# SMALL["sam_512"] cell model's 3x3 windows on a 4x4 grid padded to 6x6 (9,
# 3, 3 and 1 real rows), a ragged extent, and SAM-H's 16x16 grid padded to
# 28x28 (196, 28, 28 and 4 real rows of 14x14 windows).
VALID_CASES = [
    ("sam_512_rel", (6, 6), 8, 64, 3, (4, 4), True),
    ("sam_512", (6, 6), 8, 64, 3, (4, 4), False),
    ("ragged_rel", (6, 9), 2, 16, 3, (5, 7), True),
    ("sam_h_grid_rel", (28, 28), 2, 16, 14, (16, 16), True),
]


@pytest.mark.parametrize("case", VALID_CASES, ids=[c[0] for c in VALID_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_real_rows_match_full_grid(case, dtype):
    """With ``valid`` the plain version gives the full grid's real rows, bit
    for bit, the JAX kernel's real rows within TOL, and NaN elsewhere."""
    _, (hp, wp), heads, hd, window, (h, w), rel = case
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((2, hp, wp, 3 * heads * hd)).astype(np.float32)
    rh = rw = None
    if rel:
        rh = _toeplitz(rng.standard_normal((2 * window - 1, hd)).astype(np.float32) * 0.5, window)
        rw = _toeplitz(rng.standard_normal((2 * window - 1, hd)).astype(np.float32) * 0.5, window)
    tdt, jdt, scale = getattr(torch, dtype), jnp.dtype(dtype), hd**-0.5
    tables = [None if t is None else torch.from_numpy(t).to(tdt) for t in (rh, rw)]
    full = window_attention_reference(torch.from_numpy(qkv).to(tdt), heads, window, scale, *tables)
    got = window_attention_reference(torch.from_numpy(qkv).to(tdt), heads, window, scale, *tables,
                                     valid=(h, w))
    assert got.shape == full.shape and got.dtype == tdt
    assert torch.equal(got[:, :h, :w], full[:, :h, :w])
    pad = torch.ones(hp, wp, dtype=torch.bool)
    pad[:h, :w] = False
    assert bool(got[:, pad].isnan().all()) and not bool(got[:, ~pad].isnan().any())
    want = jax_window_attention(
        jnp.asarray(qkv, jdt), heads, window, scale,
        *(None if t is None else jnp.asarray(t, jdt) for t in (rh, rw)), interpret=True)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got[:, :h, :w].float().numpy(),
                               np.asarray(want, np.float32)[:, :h, :w], atol=atol, rtol=rtol)


@pytest.mark.parametrize("window,valid", [(3, (0, 4)), (3, (4, -1)), (3, (7, 4)), (3, (4, 7)),
                                          (0, (4, 4)), (0, (6, 5))])
def test_valid_rejects_bad_extent(window, valid):
    """Non-positive sizes, sizes past the grid, and global attention with
    less than the whole grid raise (the wrapper's check, on the CPU too)."""
    qkv = torch.zeros((1, 6, 6, 96))
    with pytest.raises(ValueError, match="valid"):
        window_attention(qkv, 2, window, 0.25, valid=valid)


def test_reference_bf16_rounds_like_jax_kernel():
    """bf16 in, bf16 out: the port rounds q*scale, the rel values and P where
    the TPU kernel does, so most outputs are the very same bf16 values."""
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((1, 6, 6, 96)).astype(np.float32)
    rh = _toeplitz(rng.standard_normal((5, 16)).astype(np.float32) * 0.5, 3)
    want = np.asarray(jax_window_attention(
        jnp.asarray(qkv, jnp.bfloat16), 2, 3, 0.25, jnp.asarray(rh, jnp.bfloat16),
        jnp.asarray(rh, jnp.bfloat16), interpret=True), np.float32)
    r = torch.from_numpy(rh).bfloat16()
    got = window_attention_reference(torch.from_numpy(qkv).bfloat16(), 2, 3, 0.25, r, r)
    assert np.mean(got.float().numpy() == want) >= 0.9


@pytest.mark.parametrize("q_size,table", [(14, 27), (14, 127), (16, 127), (16, 31), (3, 2)])
def test_get_rel_pos_matches_jax(q_size, table):
    """Slices, and antialiased linear resizes up and down, as jax.image."""
    rel = np.random.default_rng(1).standard_normal((table, 80)).astype(np.float32)
    want = np.asarray(jvit._get_rel_pos(q_size, q_size, jnp.asarray(rel)))
    got = _get_rel_pos(q_size, q_size, torch.from_numpy(rel)).numpy()
    assert got.shape == (q_size, q_size, 80)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(7, 7), (7, 12), (164, 82), (164, 328), (127, 31)])
def test_resize_weights_match_jax(n_in, n_out):
    x = np.eye(n_in, dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out, n_in), method="linear"))
    np.testing.assert_allclose(linear_resize_weights(n_in, n_out), want, atol=1e-7)


# (name, x shape, window, rel-pos, mlp names): SAM windowed with padding
# (4x4 grid -> 6x6 for 3x3 windows), SAM global, and the cls-token row.
MODULE_CASES = [
    ("sam_windowed", (2, 4, 4, 32), 3, True, ("mlp.lin1", "mlp.lin2")),
    ("sam_global", (2, 4, 4, 32), 0, True, ("mlp.lin1", "mlp.lin2")),
    ("cls_row", (2, 1, 17, 32), 0, False, ("mlp.fc1", "mlp.fc2")),
]
MODULE_TOL = {"float32": 1e-5, "bfloat16": 6e-2}


def _module_pair(kind, shape, window, rel, names, dtype):
    jdt = jnp.dtype(dtype)
    _, h, w, dim = shape
    if kind == "attention":
        flax_m = jvit.Attention(dim, 2, use_rel_pos=rel, window_size=window, dtype=jdt)
        torch_m = Attention(dim, 2, rel, window, (h, w))
    else:
        flax_m = jvit.Block(dim, 2, 2.0, window, rel, mlp_naming=names, dtype=jdt)
        torch_m = Block(dim, 2, 2.0, window, rel, names, (h, w))
    return flax_m, torch_m


@pytest.mark.parametrize("kind", ["attention", "block"])
@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_matches_flax(kind, case, dtype):
    """Attention / Block in f32 (JAX's exact XLA formulation) and bf16 (JAX
    folds rel-pos into QK, which rounds elsewhere than K2: JAX's own bar)."""
    _, shape, window, rel, names = case
    flax_m, torch_m = _module_pair(kind, shape, window, rel, names, dtype)
    params = flax_init_random(flax_m, shape, seed=2)
    x = (np.random.default_rng(4).standard_normal(shape) * 0.5).astype(np.float32)
    want = np.asarray(flax_m.apply({"params": params}, jnp.asarray(x)), np.float32)
    torch_m.load_state_dict(flax_params_to_state_dict(params, torch_m), strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad(), compute_in(getattr(torch, dtype), xt):
        got = torch_m(xt).float().numpy()
    tol = MODULE_TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if rel and dtype == "float32":  # not degenerate: rel-pos moves the output
        zero = {**params, "rel_pos_h": 0 * params["rel_pos_h"], "rel_pos_w": 0 * params["rel_pos_w"]} \
            if kind == "attention" else \
            {**params, "attn": {**params["attn"], "rel_pos_h": 0 * params["attn"]["rel_pos_h"],
                                "rel_pos_w": 0 * params["attn"]["rel_pos_w"]}}
        plain = np.asarray(flax_m.apply({"params": zero}, jnp.asarray(x)), np.float32)
        assert np.abs(plain - want).max() > 1e-2


def test_padding_carries_the_qkv_bias():
    """In a padded window the pad tokens hold the qkv bias: the port's
    output on real tokens changes when the bias changes only through them."""
    shape = (1, 4, 4, 32)
    flax_m, torch_m = _module_pair("attention", shape, 3, True, None, "float32")
    params = flax_init_random(flax_m, shape, seed=5)
    torch_m.load_state_dict(flax_params_to_state_dict(params, torch_m), strict=True)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        qkv = torch_m.qkv(x)
        padded = torch_m.qkv.bias.expand(1, 6, 6, 96).clone()
        padded[:, :4, :4] = qkv
        rh = _get_rel_pos(3, 3, torch_m.rel_pos_h)
        rw = _get_rel_pos(3, 3, torch_m.rel_pos_w)
        core = window_attention_reference(padded, 2, 3, 16**-0.5, rh, rw)[:, :4, :4]
        np.testing.assert_allclose(torch_m(x).numpy(), torch_m.proj(core).numpy(), atol=1e-6)
        zero_pad = padded.clone()
        zero_pad[:, 4:] = 0
        zero_pad[:, :, 4:] = 0
        other = window_attention_reference(zero_pad, 2, 3, 16**-0.5, rh, rw)[:, :4, :4]
    assert float((other - core).abs().max()) > 1e-3


def test_bf16_tables_are_ml_dtypes_compatible():
    """The bf16 values the two frameworks hand each other are the same bits."""
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    a = torch.from_numpy(x).bfloat16().float().numpy()
    b = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(a, b)
