"""The port's ResNet family and weight loading against the JAX package.

Same weights through both: the flax model's param tree (its ``init`` under
``jax.eval_shape``) filled from numpy, batch-norm statistics included,
carried into torch by ``flax_params_to_state_dict``; the same seeded input,
NHWC for flax and NCHW for torch."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_refs  # noqa: E402
from flax_random_params import random_flax_params  # noqa: E402
from wsinsight_tpu.models.convert import save_flax_params  # noqa: E402
from wsinsight_tpu.models.layers import TorchConv  # noqa: E402
from wsinsight_tpu.zoo import make_random_local_model as jax_make_random  # noqa: E402
from wsinsight_tpu_torch.errors import UnknownArchitectureError  # noqa: E402
from wsinsight_tpu_torch.models import create_model  # noqa: E402
from wsinsight_tpu_torch.models.convert import (  # noqa: E402
    flax_params_to_state_dict,
    load_flax_msgpack,
    load_torch_weights,
)
from wsinsight_tpu_torch.models.layers import Conv2d  # noqa: E402
from wsinsight_tpu_torch.zoo import (  # noqa: E402
    get_registered_model,
    load_local_model,
    make_random_local_model,
)

ARCHS = [("resnet34", 2), ("resnet50", 3), ("preactresnet34", 2)]


@pytest.mark.parametrize("arch,num_classes", ARCHS)
def test_logits_match_flax(arch, num_classes):
    flax_model, params = random_flax_params(arch, num_classes, 64)
    x = (np.random.default_rng(0).standard_normal((2, 64, 64, 3)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(flax_model.apply)({"params": params}, jnp.asarray(x)))

    model = create_model(arch, num_classes)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("padding", [1, ((0, 1), (0, 1)), ((2, 0), 1)])
def test_conv_padding_matches_flax(padding):
    """Symmetric and per-side (TF-SAME style) padding, stride 2."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 10, 4)).astype(np.float32)
    pads = padding if isinstance(padding, tuple) else (padding, padding)
    flax_conv = TorchConv(5, (3, 3), (2, 2), pads, use_bias=True)
    params = flax_conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(flax_conv.apply({"params": params}, jnp.asarray(x)))
    conv = Conv2d(4, 5, 3, 2, padding)
    sd = flax_params_to_state_dict({"conv": params})
    conv.load_state_dict({k.removeprefix("conv."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize(
    "arch,ref",
    [
        ("resnet34", lambda: torch_refs.torch_resnet34(2)),
        ("resnet50", lambda: torch_refs.torch_resnet50(2)),
        ("preactresnet34", lambda: torch_refs.torch_preactresnet34(2)),
    ],
)
def test_torchvision_state_dict_loads_strict(arch, ref, tmp_path):
    """A torchvision-style checkpoint loads as it is (``strict=True``), also
    through ``load_torch_weights`` with a DataParallel prefix, and the port
    then computes what the torch reference computes."""
    torch.manual_seed(0)
    ref_model = ref().eval()
    path = tmp_path / "w.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in ref_model.state_dict().items()}}, path)
    model = create_model(arch, 2)
    model.load_state_dict(load_torch_weights(path), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model(x), ref_model(x), atol=2e-4, rtol=1e-4)


def test_torchscript_checkpoint_loads(tmp_path):
    ref_model = torch_refs.torch_resnet34(2).eval()
    path = tmp_path / "w.ts"
    torch.jit.script(ref_model).save(str(path))
    model = create_model("resnet34", 2)
    model.load_state_dict(load_torch_weights(path), strict=True)


def test_jax_random_msgpack_loads_through_model_handle(tmp_path):
    cfg, weights = jax_make_random("resnet34", 2, tmp_path, patch_size_pixels=96, resize_size=64)
    handle = load_local_model(cfg, weights)
    sd = handle.load_state_dict()
    model = create_model(handle.config.architecture, handle.config.num_classes)
    model.load_state_dict(sd, strict=True)
    # The msgpack reader decodes flax's ndarray ext type byte for byte.
    from flax import serialization

    ref = serialization.msgpack_restore(weights.read_bytes())
    got = load_flax_msgpack(weights)
    assert got.keys() == ref.keys()
    for mod in ref:
        for leaf in ref[mod]:
            np.testing.assert_array_equal(got[mod][leaf], np.asarray(ref[mod][leaf]))
    kernel = ref["layer2.0.conv1"]["kernel"]  # (kh, kw, in, out) -> (out, in, kh, kw)
    np.testing.assert_array_equal(sd["layer2.0.conv1.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), ref["fc"]["kernel"].T)


def test_flax_state_dict_round_trip(tmp_path):
    """flax -> torch -> msgpack -> torch keeps every tensor."""
    _, params = random_flax_params("preactresnet34", 2, 32, seed=1)
    path = tmp_path / "p.msgpack"
    save_flax_params(params, path)
    a = flax_params_to_state_dict(params)
    b = flax_params_to_state_dict(load_flax_msgpack(path))
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_random_local_model_is_seeded(tmp_path):
    paths = [make_random_local_model("resnet34", 2, tmp_path / d, resize_size=32, seed=s)
             for d, s in (("a", 0), ("b", 0), ("c", 1))]
    sds = [load_local_model(*p).load_state_dict() for p in paths]
    torch.testing.assert_close(sds[0], sds[1], rtol=0, atol=0)
    assert not torch.equal(sds[0]["conv1.weight"], sds[2]["conv1.weight"])


def test_registry_copy_matches_jax():
    from wsinsight_tpu.zoo import get_registered_model as jax_get

    name = "breast-tumor-resnet34.tcga-brca"
    assert get_registered_model(name).config.to_dict() == jax_get(name).config.to_dict()


@pytest.mark.parametrize("arch", ["vit_giant_patch14", "not_a_net"])
def test_unported_architecture_raises(arch):
    with pytest.raises(UnknownArchitectureError, match="not yet ported"):
        create_model(arch, 2)


PORT_MODULES = (
    "engine.runner", "engine.cells", "engine.stitch", "models.resnet", "models.vit",
    "models.cellvit", "models.convert", "ops.fused_preprocess", "ops.flash_attn",
    "ops.resize", "ops.cuda_build", "zoo",
    # the classifier's host stack
    "geometry", "uri_path", "wsi", "wsi.tiff", "wsi.slide", "patchlib.morphology",
    "patchlib.segment", "patchlib.patch", "patchlib.io", "patchlib.pipeline",
    "utils.workers", "utils.metadata", "utils.profiling", "engine.data", "cli._options",
    "cli.patch", "cli.infer", "cli.run", "cli.cli", "__main__", "_version",
    # the host library and the classifier's input options
    "native", "ops.native_build", "ops.stain",
    # the cell path's host half
    "ops.watershed", "ops.hv_postproc", "ops.hv_device",
    # the zoo's other classifiers, the exporters and tosbu
    "models.vgg", "models.inception_v4", "writers", "writers.common", "writers.wkt",
    "writers.geojson", "writers.omecsv", "writers.qupath", "cli.convert_csv_to_sbubmi",
    # HoVer-Net and StarDist
    "models.hovernet", "models.stardist",
    # the analytics and their CLI
    "insightlib", "insightlib.helpers", "insightlib.voronoi", "insightlib.voronoi_exact",
    "insightlib.hplot", "insightlib.gnn", "insightlib.cme", "insightlib.foundation",
    "insightlib.stats", "cli.hplot", "cli.cme",
    # the devices, multi-host runs and the models command
    "parallel.mesh", "parallel.multihost", "cli.models_cmd",
)


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax, flax or wsinsight_tpu,
    and the cell path's modules are among those imported."""
    code = (
        "import importlib, pkgutil, sys, wsinsight_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'wsinsight_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('wsinsight_tpu_torch')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert {f"wsinsight_tpu_torch.{m}" for m in PORT_MODULES} <= loaded


def test_port_imports_without_h5py_or_psutil():
    """Every module of the port imports where h5py, psutil, scikit-learn,
    joblib and timm are missing (the H100 host the port is measured on has
    none of them), still loading no jax, flax or wsinsight_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['psutil'] = None\n"
        "sys.modules['sklearn'] = None\n"
        "sys.modules['joblib'] = None\n"
        "sys.modules['timm'] = None\n"
        "import wsinsight_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'wsinsight_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('wsinsight_tpu_torch')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert {f"wsinsight_tpu_torch.{m}" for m in PORT_MODULES} <= set(out.stdout.split())
