"""The zoo's other classifiers in the port (VGG16 / vgg16mod, InceptionV4 with
and without batch norm) against the JAX package: the models. Their engines
are in tests/test_torch_zoo_engines.py, WSINSIGHT_PRECISION and the
slide-to-GeoJSON run in tests/test_torch_zoo_precision.py.

Same weights through both: the flax model's param tree (``jax.eval_shape``
of its ``init``) filled from numpy by ``random_flax_params``, carried into
torch by ``flax_params_to_state_dict``; the same seeded inputs. Bars: logits
``atol=5e-4, rtol=1e-4`` (tests/test_model_parity.py), probabilities 2e-4 in
parity, 0.01 in bf16. The port runs on the CPU."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_refs  # noqa: E402
from flax_random_params import random_flax_params  # noqa: E402
from wsinsight_tpu.models import _REGISTRY as JAX_REGISTRY  # noqa: E402
from wsinsight_tpu.models.convert import save_flax_params  # noqa: E402
from wsinsight_tpu.zoo import get_registered_model as jax_registered  # noqa: E402
from wsinsight_tpu_torch.models import create_model  # noqa: E402
from wsinsight_tpu_torch.models.convert import flax_params_to_state_dict  # noqa: E402
from wsinsight_tpu_torch.models.inception_v4 import InceptionV4  # noqa: E402
from wsinsight_tpu_torch.models.vgg import VGG16  # noqa: E402
from wsinsight_tpu_torch.zoo import load_local_model, make_random_local_model  # noqa: E402

LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)
VGG_MODEL = "breast-tumor-vgg16mod.tcga-brca"
INCEPTION_MODEL = "breast-tumor-inception_v4.tcga-brca"
LYMPHOCYTE_MODEL = "pancancer-lymphocytes-inceptionv4.tcga"
ENV = ("WSINSIGHT_PRECISION", "WSINSIGHT_PALLAS_PREPROCESS", "WSINSIGHT_WIRE",
       "WSINSIGHT_HOST_RESIZE", "WSINSIGHT_DECODE_SCALE", "WSINSIGHT_PROFILE",
       "JAX_COORDINATOR_ADDRESS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def flax_params():
    """Seeded flax params per architecture, made once: VGG16's do not depend
    on the input size (its classifier always takes 512 x 7 x 7)."""
    cache = {}

    def get(arch, size):
        key = arch if arch.startswith("vgg") else (arch, size)
        if key not in cache:
            cache[key] = random_flax_params(arch, 2, size)
        return cache[key]

    return get


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("arch,size", [
    ("vgg16mod", 32),  # 1 x 1 features, spread over the 7 x 7 pool
    ("vgg16mod", 64),  # 2 x 2 features: overlapping adaptive-pool bins
    ("inception_v4", 128),
    ("inception_v4nobn", 128),
    ("inception_v4nobn", 100),  # the lymphocyte model's patch: 1 x 1 after ReductionB
])
def test_logits_match_flax(flax_params, arch, size):
    flax_model, params = flax_params(arch, size)
    x = (np.random.default_rng(0).standard_normal((2, size, size, 3)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(flax_model.apply)({"params": params}, jnp.asarray(x)))

    model = create_model(arch, 2)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert np.abs(want[:, 1] - want[:, 0]).max() > 1e-3  # the logits are not degenerate


def test_vgg16_flatten_is_torch_order(flax_params):
    """Under channels_last the flatten still reads (C, 7, 7) order: the same
    weights give the NCHW-contiguous input's logits, and a classifier.0
    whose columns are permuted to (7, 7, C) order gives other logits."""
    _, params = flax_params("vgg16mod", 64)
    model = create_model("vgg16mod", 2)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        last = model(_nchw(x))
        first = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        torch.testing.assert_close(last, first, rtol=1e-5, atol=1e-5)
        w = model.classifier[0].weight
        w.copy_(w.reshape(-1, 512, 7, 7).permute(0, 2, 3, 1).reshape(w.shape))
        assert (model(_nchw(x)) - last).abs().max() > 1e-3


@pytest.mark.parametrize("alias", sorted(
    k for k, fn in JAX_REGISTRY.items() if fn.__name__ in ("vgg16", "inception_v4", "inception_v4nobn")
))
def test_every_jax_alias_builds_the_same_model(alias):
    """Every alias the JAX registry has for the three builds the port's
    module of the same architecture (hyphens read as underscores)."""
    fn = JAX_REGISTRY[alias].__name__
    model = create_model(alias.replace("_", "-"), 3)
    if fn == "vgg16":
        assert type(model) is VGG16 and model.classifier[6].out_features == 3
    else:
        assert type(model) is InceptionV4 and model.last_linear.out_features == 3
        has_bn = model.features[0].bn is not None
        assert has_bn == (fn == "inception_v4")
        assert (model.features[0].conv.bias is None) == has_bn
    assert not model.training


@pytest.mark.parametrize("arch,ref,size", [
    ("vgg16", lambda: torch_refs.torch_vgg16(2), 32),
    ("inception_v4", lambda: torch_refs.torch_inceptionv4(2, bn=True), 80),
    ("inception_v4nobn", lambda: torch_refs.torch_inceptionv4(2, bn=False), 80),
])
def test_zoo_state_dict_loads_strict(arch, ref, size):
    """A state dict in the zoo checkpoints' layout (torchvision's VGG16,
    Cadene's InceptionV4: tests/torch_refs.py) loads with strict=True and
    gives that module's logits; the port's own state dict round-trips."""
    torch.manual_seed(0)
    ref_model = ref().eval()
    with torch.no_grad():  # batch-norm statistics that matter
        for m in ref_model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    model = create_model(arch, 2)
    model.load_state_dict(ref_model.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, size, size))
                         .astype(np.float32))
    with torch.no_grad():
        want = ref_model(x)
        got = model(x.contiguous(memory_format=torch.channels_last))
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    again = create_model(arch, 2)
    again.load_state_dict(model.state_dict(), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


@pytest.mark.parametrize("arch,resize", [
    ("vgg16mod", 32), ("inception_v4", 80), ("inception_v4nobn", 100),
])
def test_make_random_local_model_builds_each(tmp_path, arch, resize):
    """The port's seeded checkpoint writer builds each of the three, with a
    head scaled to unit-scale logits, and its checkpoint loads strictly."""
    cfg, weights = make_random_local_model(arch, 2, tmp_path, resize_size=resize, seed=0)
    handle = load_local_model(cfg, weights)
    model = create_model(arch, 2)
    model.load_state_dict(handle.load_state_dict(model), strict=True)
    probe = torch.randn((2, 3, resize, resize), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        logits = model(probe)
    assert torch.isfinite(logits).all() and 0.05 < float(logits.std()) < 20


def _local_model(out, registered: str, arch: str, size: int, resize: int | None = None,
                 head_scale: float = 1.0):
    """A local model: the zoo config of ``registered`` with the patch (and
    Resize) cut to ``size`` (``resize``), and seeded flax params for it, the
    head's kernel multiplied by ``head_scale``."""
    config = jax_registered(registered).config.to_dict()
    config["patch_size_pixels"] = size
    for t in config["transform"]:
        if t["name"] == "Resize":
            t["arguments"]["size"] = resize or size
    out.mkdir(parents=True, exist_ok=True)
    cfg = out / "config.json"
    cfg.write_text(json.dumps(config))
    weights = out / "weights.msgpack"
    params = random_flax_params(arch, 2, resize or size)[1]
    head = next(params[k] for k in ("fc", "last_linear", "classifier.6") if k in params)
    head["kernel"] = head["kernel"] * np.float32(head_scale)
    save_flax_params(params, weights)
    return cfg, weights
