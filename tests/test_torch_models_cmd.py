"""The port's `wsinsight models` command and its flax templates against the
JAX package's.

The template (``models.convert.flax_template``, built from the port's module
on the meta device) is held to ``jax.eval_shape`` of the flax model's
``init`` for every architecture of the registry: the same nesting, leaf
names and shapes. The command runs in both CLIs on the same seeded torch
checkpoints: the same output text and exit code, and byte-identical msgpack
files. No flax is needed by the port."""

import hashlib
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from torch_refs import torch_resnet34  # noqa: E402
from wsinsight_tpu.cli.cli import cli as jax_cli  # noqa: E402
from wsinsight_tpu.models import create_model as jax_create_model  # noqa: E402
from wsinsight_tpu.models import convert as jax_convert  # noqa: E402
from wsinsight_tpu_torch.cli.cli import cli as port_cli  # noqa: E402
from wsinsight_tpu_torch.models import create_model  # noqa: E402
from wsinsight_tpu_torch.models.convert import (  # noqa: E402
    convert_with_template,
    flax_template,
    load_flax_msgpack,
    normalize_hovernet_keys,
)
from wsinsight_tpu_torch.zoo import randomize_cell_model  # noqa: E402

ARCHITECTURES = ["resnet34", "resnet50", "preactresnet34", "vgg16mod", "inception_v4",
                 "inception_v4nobn", "cellvit-256", "cellvit-sam-h", "cellvit-virchow",
                 "hovernet-fast"]


def _shapes(tree, prefix=""):
    """{'/'-joined path: shape} of a nested params tree."""
    out = {}
    for name, child in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if hasattr(child, "items"):
            out.update(_shapes(child, path))
        else:
            out[path] = tuple(np.shape(child))
    return out


def _jax_template(arch, num_classes, size):
    model = jax_create_model(arch, num_classes)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_template_matches_eval_shape(arch):
    """The flax tree without flax: nesting, names and shapes of init's."""
    cell = arch.startswith(("cellvit", "hovernet"))
    size = 256 if cell else 224
    want = _shapes(_jax_template(arch, 6 if cell else 3, size))
    got = flax_template(arch, 6 if cell else 3, size)
    assert _shapes(got) == want
    leaves = jax.tree_util.tree_leaves(got)
    assert all(leaf.dtype == np.float32 for leaf in leaves)
    assert sum(leaf.nbytes for leaf in leaves) < 2**40  # views: no weights allocated


@pytest.fixture(scope="module")
def resnet34_checkpoint(tmp_path_factory):
    """A seeded torch_refs ResNet34 state dict (2 classes), batch-norm
    statistics randomized, saved as a .pt file."""
    torch.manual_seed(7)
    model = torch_resnet34(2)
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    path = tmp_path_factory.mktemp("ckpt") / "resnet34.pt"
    torch.save(model.state_dict(), path)
    return path


def _both(args, tmp_path):
    """Both CLIs on ``args`` (``OUT`` replaced by a file of each one's
    directory): [(exit code, output with the path written as OUT, file
    bytes or None)] for the JAX CLI, then the port's."""
    results = []
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        out = tmp_path / name / "out.msgpack"
        out.parent.mkdir()
        res = CliRunner().invoke(cli, [str(out) if a == "OUT" else a for a in args])
        assert res.exception is None or isinstance(res.exception, SystemExit), res.output
        data = out.read_bytes() if out.exists() else None
        results.append((res.exit_code, res.output.replace(str(out), "OUT"), data))
    return results


def test_convert_report_matches_jax(resnet34_checkpoint, tmp_path):
    """`models convert IN OUT --report` on a ResNet34 checkpoint: the JAX
    command's output text and a byte-identical file (the same sha256)."""
    (jax_rc, jax_out, jax_file), (rc, out, file) = _both(
        ["models", "convert", str(resnet34_checkpoint), "OUT", "--architecture", "resnet34",
         "--num-classes", "2", "--report"], tmp_path)
    assert rc == jax_rc == 0
    assert out == jax_out
    assert "mapping complete" in out and "template leaves filled: 182/182" in out
    assert file is not None and file == jax_file
    assert f"sha256={hashlib.sha256(file).hexdigest()}" in out


@pytest.mark.parametrize("num_classes,code", [(2, 0), (3, 1)], ids=["complete", "mismatch"])
def test_report_only_matches_jax(resnet34_checkpoint, tmp_path, num_classes, code):
    """Report-only mode (no OUTPUT): the same text and exit code, for a
    complete mapping and for a head of the wrong width."""
    (jax_rc, jax_out, _), (rc, out, file) = _both(
        ["models", "convert", str(resnet34_checkpoint), "--architecture", "resnet34",
         "--num-classes", str(num_classes), "--report"], tmp_path)
    assert rc == jax_rc == code
    assert out == jax_out and file is None
    assert ("!" in out) == bool(code)


@pytest.mark.parametrize("args", [["models"], ["models", "ls"]], ids=["bare", "ls"])
def test_registry_listing_matches_jax(args, tmp_path):
    (jax_rc, jax_out, _), (rc, out, _) = _both(args, tmp_path)
    assert rc == jax_rc == 0 and out == jax_out
    assert "breast-tumor-resnet34.tcga-brca" in out


def test_convert_plain_writes_flax_bytes(resnet34_checkpoint, tmp_path):
    """Without --report: the same file, which the port's own reader loads
    back leaf for leaf as the template's tree."""
    (_, jax_out, jax_file), (rc, out, file) = _both(
        ["models", "convert", str(resnet34_checkpoint), "OUT", "--architecture", "resnet34",
         "--num-classes", "2"], tmp_path)
    assert rc == 0 and out == jax_out and file == jax_file
    path = tmp_path / "port" / "out.msgpack"
    assert _shapes(load_flax_msgpack(path)) == _shapes(flax_template("resnet34", 2))


def _released_spelling(sd):
    """A port HoVer-Net state dict under the released hover_net names."""
    out = OrderedDict()
    for k, v in sd.items():
        k = k.replace("conv0.conv.", "conv0./.")
        for bn in ("preact_bn", "conv1_bn", "conv2_bn", "preact_bna_bn"):
            k = k.replace(f".{bn}.", f".{bn[:-3]}/bn.")
        out[k] = v
    out["upsample2x.unpool_mat"] = torch.ones((2, 2))
    return out


@pytest.mark.parametrize("arch", ["hovernet-fast", "cellvit-256"])
def test_nested_family_converts_as_jax(arch):
    """A nested family's seeded checkpoint (HoVer-Net under the released key
    spellings, CellViT-256): the port's conversion onto its own template
    equals the JAX converter's onto eval_shape's, leaf for leaf."""
    model = randomize_cell_model(create_model(arch, 3, img_size=256), seed=4)
    sd = model.state_dict()
    if arch == "hovernet-fast":
        sd = _released_spelling(sd)
        jax_sd = jax_convert.normalize_hovernet_keys(
            {k: v.numpy() for k, v in sd.items()})
        sd = normalize_hovernet_keys(sd)
    else:
        jax_sd = {k: v.numpy() for k, v in sd.items()}
    want = jax_convert.convert_with_template(jax_sd, _jax_template(arch, 3, 256))
    got = convert_with_template(sd, flax_template(arch, 3, 256))
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == np.float32 and np.array_equal(a, b), jax.tree_util.keystr(path)
