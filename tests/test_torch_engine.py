"""The port's ClassifierEngine against the JAX ClassifierEngine.

Both engines load the same local model (a flax msgpack) and get the same
seeded uint8 patches; the port runs with ``device="cpu"``. The model's batch
norms are random and its head is scaled to unit-scale logits, so the
probabilities are not saturated and the comparison sees the numerics."""

import json
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flax_random_params import random_flax_params  # noqa: E402
from wsinsight_tpu.engine.runner import ClassifierEngine as JaxEngine  # noqa: E402
from wsinsight_tpu.models.convert import save_flax_params  # noqa: E402
from wsinsight_tpu.zoo import ModelConfiguration, TransformConfigurationItem  # noqa: E402
from wsinsight_tpu.zoo import load_local_model as jax_load_local  # noqa: E402
from wsinsight_tpu_torch.engine import ClassifierEngine  # noqa: E402
from wsinsight_tpu_torch.models import create_model  # noqa: E402
from wsinsight_tpu_torch.models.convert import flax_params_to_state_dict  # noqa: E402
from wsinsight_tpu_torch.ops.fused_preprocess import fused_preprocess  # noqa: E402
from wsinsight_tpu_torch.zoo import load_local_model  # noqa: E402

_ENV = ("WSINSIGHT_PALLAS_PREPROCESS", "WSINFER_FORCE_CPU", "WSINSIGHT_WIRE",
        "WSINSIGHT_HOST_RESIZE", "WSINSIGHT_PRECISION")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)


def _make_model(out_dir, num_classes):
    """A local ResNet34 model, 96 px patches resized to 64, as a flax
    msgpack: random weights with random batch norms, the head scaled so the
    logits have unit spread on noise (measured through the port, which the
    tests below hold to the JAX engine)."""
    _, params = random_flax_params("resnet34", num_classes, 64, seed=7)
    model = create_model("resnet34", num_classes)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        logits = model(torch.randn((4, 3, 64, 64), generator=torch.Generator().manual_seed(7)))
    params["fc"]["kernel"] = params["fc"]["kernel"] / float(logits.std())
    cfg = ModelConfiguration(
        architecture="resnet34",
        num_classes=num_classes,
        class_names=[f"class{i}" for i in range(num_classes)],
        patch_size_pixels=96,
        spacing_um_px=0.25,
        transform=[
            TransformConfigurationItem("Resize", {"size": 64}),
            TransformConfigurationItem("ToTensor"),
            TransformConfigurationItem(
                "Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
            ),
        ],
    )
    config_path, weights_path = out_dir / "config.json", out_dir / "weights.msgpack"
    config_path.write_text(json.dumps(cfg.to_dict()))
    save_flax_params(params, weights_path)
    return config_path, weights_path


@pytest.fixture(scope="module")
def two_class(tmp_path_factory):
    return _make_model(tmp_path_factory.mktemp("m2"), 2)


@pytest.fixture(scope="module")
def patches():
    return np.random.default_rng(0).integers(0, 256, size=(4, 96, 96, 3), dtype=np.uint8)


@pytest.mark.parametrize(
    "mode,atol",
    [("parity", 2e-4), ("fused", 1e-3), ("mixed", 0.01)],
)
def test_probabilities_match_jax(two_class, patches, mode, atol, monkeypatch):
    """Budgets: parity 2e-4 (1e-3 is the contract); K1 forced into parity
    1e-3 (one uint8 level of resize drift); bf16 0.01 (the JAX package's own
    bar between its bf16 and parity paths)."""
    if mode == "fused":
        monkeypatch.setenv("WSINSIGHT_PALLAS_PREPROCESS", "1")
    mixed = mode == "mixed"
    want = JaxEngine(jax_load_local(*two_class), mixed_precision=mixed, max_devices=1).run_batch(
        patches, 4
    )
    engine = ClassifierEngine(load_local_model(*two_class), mixed_precision=mixed, device="cpu")
    assert (engine._preprocess.__qualname__ == "make_fused_preprocess_fn.<locals>.fn") == (
        mode != "parity"
    )
    before = fused_preprocess.launches
    got = engine.run_batch(patches, 3)
    assert fused_preprocess.launches == before  # the CPU runs the plain version
    assert got.shape == (3, 2) and got.dtype == np.float32
    assert 0.05 < got.min() and got.max() < 0.95  # not saturated
    np.testing.assert_allclose(got, want[:3], atol=atol)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_sigmoid_single_class_matches_jax(tmp_path, patches):
    model = _make_model(tmp_path, 1)
    want = JaxEngine(jax_load_local(*model), max_devices=1).run_batch(patches, 4)
    got = ClassifierEngine(load_local_model(*model), device="cpu").run_batch(patches, 4)
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_two_deep_window_matches_run_batch(two_class, patches):
    """put -> dispatch, two batches in flight, as run_inference drives it."""
    engine = ClassifierEngine(load_local_model(*two_class), device="cpu")
    assert engine.n_devices == 1 and engine.pad_batch(5) == 5
    batches = [patches[i : i + 2] for i in (0, 2, 0)]
    pending, out = deque(), []
    for b in batches:
        pending.append(engine.dispatch(engine.put(b)))
        if len(pending) > 2:
            out.append(pending.popleft().cpu().numpy())
    out += [p.cpu().numpy() for p in pending]
    want = [engine.run_batch(b, 2) for b in batches]
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)


def test_device_rule(two_class, monkeypatch):
    """No CUDA, no device="cpu", no WSINFER_FORCE_CPU: the engine raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    handle = load_local_model(*two_class)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClassifierEngine(handle)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClassifierEngine(handle, device="cuda")
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    assert ClassifierEngine(handle).device == torch.device("cpu")


@pytest.mark.parametrize(
    "env,kwargs",
    [
        (None, dict(w_est=np.eye(3), w_def=np.eye(3))),
        (("WSINSIGHT_WIRE", "yuv420"), {}),
        (("WSINSIGHT_HOST_RESIZE", "1"), {}),
        (("WSINSIGHT_PRECISION", "float32"), {}),
    ],
    ids=["stain", "yuv420", "host-resize", "precision"],
)
def test_unported_options_raise(two_class, monkeypatch, env, kwargs):
    if env:
        monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ClassifierEngine(load_local_model(*two_class), device="cpu", **kwargs)


def test_set_stains_raises(two_class):
    engine = ClassifierEngine(load_local_model(*two_class), device="cpu")
    with pytest.raises(NotImplementedError):
        engine.set_stains(np.eye(3), np.eye(3))
