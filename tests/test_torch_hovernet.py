"""The port's HoVer-Net fast (model, weights, CellEngine) against the JAX
package.

Same weights through both: the flax model's param tree (``jax.eval_shape``
of its ``init``) filled from numpy by ``random_flax_params``, batch-norm
statistics randomized, carried into torch by ``flax_params_to_state_dict``;
or one checkpoint file loaded by both packages. The same seeded inputs. Bars:
maps ``atol=1e-3, rtol=1e-4`` in float32 (tests/test_model_parity.py's bar
for HoVer-Net), NP > 0.5 decisions agreeing on >= 99% of pixels in bf16 (the
cell path's bf16 bar). The port runs on the CPU."""

from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flax_random_params import random_flax_params  # noqa: E402
from wsinsight_tpu.engine.cells import CellEngine as JaxCellEngine  # noqa: E402
from wsinsight_tpu.models.convert import normalize_hovernet_keys as jax_normalize  # noqa: E402
from wsinsight_tpu.models.hovernet import tf_same_pads as jax_tf_same_pads  # noqa: E402
from wsinsight_tpu.zoo import load_local_model as jax_load_local  # noqa: E402
from wsinsight_tpu_torch.engine import CellEngine  # noqa: E402
from wsinsight_tpu_torch.models import create_model  # noqa: E402
from wsinsight_tpu_torch.models.convert import (  # noqa: E402
    flax_params_to_state_dict,
    normalize_hovernet_keys,
)
from wsinsight_tpu_torch.models.hovernet import HoVerNetFast, tf_same_pads  # noqa: E402
from wsinsight_tpu_torch.zoo import (  # noqa: E402
    ModelHandle,
    get_registered_model,
    load_local_model,
    make_random_local_model,
    randomize_cell_model,
)

MAPS = ("nuclei_binary_map", "hv_map", "nuclei_type_map")
MAP_TOL = dict(atol=1e-3, rtol=1e-4)
# (patch side, halo): the smallest side the VALID arithmetic admits at the
# built-in halo (4 x 4 maps), and a halo past 46 whose extra 4 px are cropped
SIZES = [(96, 46), (128, 50)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    for var in ("WSINSIGHT_PRECISION", "WSINSIGHT_WIRE", "WSINSIGHT_PROFILE"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def flax_hovernet():
    """(flax HoVer-Net, seeded params, 3 classes). Conv kernels at variance
    1/fan-in: with batch norms that do not normalize (random statistics),
    He's 2/fan-in grows the 16 residual units' sum to maps of 1e4."""
    return random_flax_params("hovernet-fast", 3, 96, conv_gain=1.0)


def _softmax_fg(a: np.ndarray) -> np.ndarray:
    """NP > 0.5 decisions of (B, 2, H, W) logits."""
    e = np.exp(a - a.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True))[:, 1] > 0.5


def _port_model(params, halo, size, dtype=torch.float32) -> HoVerNetFast:
    model = create_model("hovernet-fast", 3, dtype=dtype, halo_size=halo, img_size=size)
    model.load_state_dict(flax_params_to_state_dict(params, model), strict=True)
    return model


@pytest.mark.parametrize("size,halo", SIZES)
def test_maps_match_flax(flax_hovernet, size, halo):
    flax_model, params = flax_hovernet
    x = (np.random.default_rng(size).standard_normal((2, size, size, 3)) * 0.5).astype(np.float32)
    want = jax.jit(flax_model.clone(halo_size=halo).apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(params, halo, size)(torch.from_numpy(x))
    out = size - 2 * halo
    for key in MAPS:
        w = np.asarray(want[key])
        assert got[key].dtype == torch.float32 and got[key].shape == w.shape, key
        assert w.shape[2:] == (out, out)
        np.testing.assert_allclose(got[key].numpy(), w, **MAP_TOL, err_msg=key)
        assert w.std() > 0.05, key  # maps that vary: the input reaches them


@pytest.mark.parametrize("size,halo", SIZES)
def test_bf16_matches_jax_bf16(flax_hovernet, size, halo):
    """bf16 autocast against the flax model's bfloat16 dtype, same weights:
    NP > 0.5 decisions agree on >= 99% of pixels; every map finite."""
    flax_model, params = flax_hovernet
    x = (np.random.default_rng(size + 1).standard_normal((2, size, size, 3)) * 0.5).astype(
        np.float32)
    want = jax.jit(flax_model.clone(halo_size=halo, dtype=jnp.bfloat16).apply)(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(params, halo, size, torch.bfloat16)(torch.from_numpy(x))
    for key in MAPS:
        assert got[key].dtype == torch.float32 and bool(torch.isfinite(got[key]).all()), key
    agree = float(np.mean(_softmax_fg(got["nuclei_binary_map"].numpy())
                          == _softmax_fg(np.asarray(want["nuclei_binary_map"], np.float32))))
    drift = float(np.abs(got["nuclei_binary_map"].numpy()
                         - np.asarray(want["nuclei_binary_map"], np.float32)).max())
    print(f"{size} px bf16 port vs JAX: NP > 0.5 agrees on {agree:.4%}, max |d| NP {drift:.3g}")
    assert agree >= 0.99


@pytest.mark.parametrize("size", [96, 100, 127, 256, 7])
@pytest.mark.parametrize("ksize,stride", [(3, 1), (3, 2), (7, 1), (1, 2)])
def test_tf_same_pads_match_jax(size, ksize, stride):
    assert tf_same_pads(size, size + 1, ksize, stride) == jax_tf_same_pads(
        size, size + 1, ksize, stride)


def test_stride2_tf_same_conv_is_not_a_shifted_symmetric_pad():
    """A 3x3 stride-2 conv padded TF-SAME, (0, 1) on an even side, reads rows
    2i..2i+2. The symmetric padding=1 conv of x[..., 1:, 1:] reads the same
    rows except at output row 0 (column 0), where it reads a zero pad in
    place of x's row 0: the copy-free form is not equivalent, so the
    port pads with F.pad (layers.Conv2d), as flax does."""
    model = create_model("hovernet-fast", 3)
    conv = model.d1.units[0].conv2
    assert conv.stride == (2, 2) and conv._side_pad == (0, 1, 0, 1)
    x = torch.randn((2, 128, 32, 32), generator=torch.Generator().manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        padded = conv(x)
        shifted = torch.nn.functional.conv2d(x[:, :, 1:, 1:], conv.weight, None, 2, 1)
        explicit = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x, (0, 1, 0, 1)), conv.weight, None, 2)
    assert padded.shape == shifted.shape == (2, 128, 16, 16)
    assert torch.equal(padded, explicit)
    assert torch.equal(padded[:, :, 1:, 1:], shifted[:, :, 1:, 1:])
    assert not torch.equal(padded[:, :, 0], shifted[:, :, 0])
    assert not torch.equal(padded[:, :, :, 0], shifted[:, :, :, 0])


@pytest.mark.parametrize("halo,size", [(45, 96), (46, 100), (46, 88), (0, 256)])
def test_value_errors(halo, size):
    model = create_model("hovernet-fast", 3, halo_size=halo, img_size=size)
    with pytest.raises(ValueError, match="46 px halo|divisible by 8"):
        model(torch.zeros((1, size, size, 3)))


@pytest.mark.parametrize("alias", ["hovernet_fast", "hovernet-fast", "hovernet_fast_pannuke"])
def test_registry_aliases(alias):
    model = create_model(alias, 6)
    assert type(model) is HoVerNetFast and not model.training
    assert model.decoder["tp"].u0.conv.out_channels == 6
    # 37.6 M parameters, the released model's count
    assert sum(p.numel() for p in model.parameters()) == 37_639_626


def _released_spelling(sd: dict) -> OrderedDict:
    """A port state dict under the released hover_net names (conv0's '/'
    conv, '<x>/bn' batch norms) with UpSample2x's unpool_mat buffer."""
    out = OrderedDict()
    for k, v in sd.items():
        k = k.replace("conv0.conv.", "conv0./.")
        for bn in ("preact_bn", "conv1_bn", "conv2_bn", "preact_bna_bn"):
            k = k.replace(f".{bn}.", f".{bn[:-3]}/bn.")
        out[k] = v
    out["upsample2x.unpool_mat"] = torch.ones((2, 2))
    return out


@pytest.fixture(scope="module")
def seeded_hovernet():
    """A port HoVer-Net at 96 px with randomize_cell_model's weights, seed 3."""
    return randomize_cell_model(create_model("hovernet-fast", 3, img_size=96), seed=3)


def test_normalize_keys_load_released_spelling(seeded_hovernet):
    """The released spelling normalizes onto the port's names (the JAX
    package's normalizer gives the same keys) and loads with strict=True."""
    released = _released_spelling(seeded_hovernet.state_dict())
    assert "conv0./.weight" in released and "d0.units.1.preact/bn.running_mean" in released
    assert "decoder.np.u3.dense.units.0.preact_bna/bn.weight" in released
    normalized = normalize_hovernet_keys(released)
    assert list(normalized) == list(jax_normalize(released))
    assert normalize_hovernet_keys(normalized).keys() == normalized.keys()  # idempotent
    model = create_model("hovernet-fast", 3, img_size=96)
    model.load_state_dict(normalized, strict=True)
    x = torch.randn((1, 96, 96, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = model(x), seeded_hovernet(x)
    for key in MAPS:
        assert torch.equal(got[key], want[key]), key


def test_torchscript_checkpoint_through_model_handle(seeded_hovernet, tmp_path):
    """A TorchScript archive holding the released spelling (a traced module:
    TorchScript keeps the '/' names) loads through ModelHandle, which
    normalizes HoVer-Net keys, into the same model."""

    class Released(torch.nn.Module):
        def forward(self, x):
            return x

    root = Released()
    for key, value in _released_spelling(seeded_hovernet.state_dict()).items():
        *path, leaf = key.split(".")
        mod = root
        for name in path:
            if not hasattr(mod, name):
                mod.add_module(name, torch.nn.Module())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, value.clone())
    ts = tmp_path / "hovernet.pt"
    torch.jit.trace(root, torch.zeros(1)).save(str(ts))

    handle = get_registered_model("hovernet_fast_pannuke")
    handle.config.num_classes = 3
    local = ModelHandle(name="hovernet", config=handle.config, weights_path=str(ts))
    model = create_model("hovernet-fast", 3, img_size=96)
    model.load_state_dict(local.load_state_dict(model), strict=True)
    for key, value in seeded_hovernet.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


def test_cell_engine_matches_jax(tmp_path):
    """make_random_local_model's seeded HoVer-Net checkpoint (a torch state
    dict) loaded by the port's CellEngine on the CPU and by the JAX
    CellEngine (template conversion of the same file): the same maps of the
    same uint8 patches within 1e-3."""
    cfg, weights = make_random_local_model("hovernet-fast", 3, tmp_path, patch_size_pixels=128)
    x = np.random.default_rng(4).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = JaxCellEngine(jax_load_local(cfg, weights), max_devices=1).run_batch(x)
    engine = CellEngine(load_local_model(cfg, weights), device="cpu")
    got = engine.run_batch(x)
    assert set(got) == set(MAPS)
    for key in MAPS:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape == (2, w.shape[1], 36, 36), key
        np.testing.assert_allclose(got[key].numpy(), w, **MAP_TOL, err_msg=key)
    # randomize_cell_model's heads give maps of unit scale
    assert 0.2 < float(got["nuclei_binary_map"].std()) < 5.0


def test_random_model_is_seeded_with_zoo_config(tmp_path):
    """make_random_local_model gives the JAX package's cell config and the
    same weights for the same seed; init_random does too, and the registry's
    hovernet_fast_pannuke (ToTensor alone) runs through CellEngine."""
    cfg, weights = make_random_local_model("hovernet-fast", 3, tmp_path / "a",
                                           patch_size_pixels=96)
    again = make_random_local_model("hovernet-fast", 3, tmp_path / "b", patch_size_pixels=96)
    a, b = (load_local_model(*c).load_state_dict() for c in ((cfg, weights), again))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    d = load_local_model(cfg, weights).config.to_dict()
    assert d["halo_size_pixels"] == 46 and d["object_detection"]["name"] == "end2end"
    assert all(not k.endswith("u0.conv.bias") or not v.any() for k, v in a.items())

    handle = get_registered_model("hovernet_fast_pannuke")
    assert [t.name for t in handle.config.transform] == ["ToTensor"]
    handle.config.patch_size_pixels = 96
    e1, e2 = (CellEngine(handle, init_random=True, device="cpu", seed=0) for _ in range(2))
    torch.testing.assert_close(e1.model.state_dict(), e2.model.state_dict(), rtol=0, atol=0)
    x = np.full((1, 96, 96, 3), 255, np.uint8)
    got = e1.run_batch(x)
    assert got["nuclei_type_map"].shape == (1, 6, 4, 4)
    # ToTensor alone: 255 -> 1.0, the same maps as the model given ones
    with torch.no_grad():
        want = e1.model(torch.ones((1, 96, 96, 3)))
    for key in MAPS:
        assert torch.equal(got[key], want[key]), key


def test_cli_runs_hovernet(tmp_path):
    """`run` with a seeded HoVer-Net local config (160 px, halo 46: a 68 px
    step) plans the halo grid and writes one CSV row per nucleus and the
    /polygons group, aligned with the rows. The HV head is zeroed, as
    tests/test_cells.py does for its end-to-end run: random HV fields leave
    no seeds; the NP head's foreground bias is raised by 0.6, as the seeded
    model puts the tissue's foreground probability near 0.3 (a third of its
    pixels above 0.5 then, in several instances)."""
    import json

    import h5py
    import pandas as pd
    from click.testing import CliRunner

    from test_torch_hoststack import _tissue_image
    from wsinsight_tpu_torch.cli.cli import cli
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff

    cfg, weights = make_random_local_model("hovernet-fast", 3, tmp_path / "m",
                                           patch_size_pixels=160)
    assert json.loads(cfg.read_text())["architecture"] == "hovernet-fast"
    state = torch.load(weights)
    for k in ("weight", "bias"):
        state[f"decoder.hv.u0.conv.{k}"].zero_()
    state["decoder.np.u0.conv.bias"][1] += 0.6
    torch.save(state, weights)
    (tmp_path / "slides").mkdir()
    write_pyramidal_tiff(str(tmp_path / "slides" / "cells.tif"), _tissue_image(768, seed=4),
                         tile=(256, 256), compression="deflate", mpp=0.25, levels=2)
    res = CliRunner().invoke(cli, [
        "run", "-i", str(tmp_path / "slides"), "-o", str(tmp_path / "r"), "--config", str(cfg),
        "--model-path", str(weights), "-b", "8", "--stitch-workers", "1",
        "--seg-thumbsize", "512", "512", "--seg-min-object-size-um2", "2500",
        "--seg-min-hole-size-um2", "100"], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    df = pd.read_csv(tmp_path / "r" / "model-outputs-csv" / "cells.csv")
    assert list(df.columns) == ["minx", "miny", "width", "height",
                                *(f"prob_class{i}" for i in range(3))]
    with h5py.File(tmp_path / "r" / "patches" / "cells.h5", "r") as f:
        coords, offsets = f["/coords"][()], f["/polygons/offsets"][()]
        rings = f["/polygons/coords"][()]
    print(f"HoVer-Net run: {len(coords)} patches, {len(df)} instances")
    assert np.diff(np.unique(coords[:, 0])).min() == 68  # 160 - 2 * 46
    assert len(df) > 0 and len(offsets) == len(df) + 1
    for (x, y, w, h), a, b in zip(df[["minx", "miny", "width", "height"]].to_numpy(),
                                  offsets[:-1], offsets[1:]):
        ring = rings[a:b]
        assert len(ring) >= 3 and (ring.min(0) >= (x, y)).all()
        assert (ring.max(0) <= (x + w - 1, y + h - 1)).all()
