"""Weights into the port: torch checkpoints, and flax params carried across.

Counterpart of wsinsight_tpu/models/convert.py. The port's modules carry
torchvision's names, so a torch checkpoint loads as it is.
``flax_params_to_state_dict`` is the inverse of the JAX package's
``convert_torch_state_dict`` / ``convert_with_template``:

* conv kernel (kh, kw, in, out)    -> weight (out, in, kh, kw)
* transposed-conv kernel (kh, kw, in, out) -> weight (in, out, kh, kw),
  spatially flipped (flax applies the kernel unflipped, torch transposes a
  cross-correlation)
* linear kernel (in, out)          -> weight (out, in)
* layer-norm ``scale``             -> ``weight``
* batch-norm leaves                -> copied, plus ``num_batches_tracked`` = 0
* raw parameters (``pos_embed``, ``cls_token``, ``rel_pos_h``/``_w``) -> copied

Conv against transposed conv is read off the port model's own module types
when the model is given: a name cannot tell them apart, and with in == out
their shapes cannot either.

Also here: ``normalize_hovernet_keys`` (released hover_net spellings onto
``models/hovernet.py``'s names), ``convert_stardist_keras_h5`` (the released
StarDist Keras weights file, read with h5py, into ``models/stardist.py``'s
state dict) and ``save_flax_msgpack``, the writer of the flax msgpack format
that ``load_flax_msgpack`` reads, without flax.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Mapping

import numpy as np
import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _strip_wrapper_prefixes(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Drop DataParallel/Lightning-style wrappers ('module.', 'model.')
    when every key carries the same prefix."""
    keys = list(sd.keys())
    for prefix in ("module.", "model.", "_orig_mod."):
        if keys and all(k.startswith(prefix) for k in keys):
            return _strip_wrapper_prefixes({k[len(prefix):]: v for k, v in sd.items()})
    return dict(sd)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, dict[str, np.ndarray]]:
    """{dotted module path: {leaf: array}} of a (possibly nested) params tree."""
    modules: dict[str, dict[str, np.ndarray]] = {}
    for name, child in tree.items():
        path = f"{prefix}.{name}" if prefix else str(name)
        if hasattr(child, "items"):
            modules.update(_flatten(child, path))
        else:
            modules.setdefault(prefix, {})[str(name)] = np.asarray(child)
    return modules


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)


def flax_params_to_state_dict(
    params: Mapping[str, Any], model: torch.nn.Module | None = None
) -> dict[str, torch.Tensor]:
    """Torch state dict from a flax ``params`` tree of numpy arrays.

    ``model`` is the port module the state dict is for; its
    ``nn.ConvTranspose2d`` submodules take the transposed-conv mapping.
    Without it every 4-D kernel is a convolution (the classifiers have no
    other)."""
    deconvs = set()
    if model is not None:
        deconvs = {name for name, m in model.named_modules()
                   if isinstance(m, torch.nn.ConvTranspose2d)}
    sd: dict[str, torch.Tensor] = {}
    for mod, leaves in _flatten(params).items():
        prefix = f"{mod}." if mod else ""
        if "running_mean" in leaves:  # batch norm
            for name in _BN_LEAVES:
                sd[prefix + name] = _f32(leaves[name])
            sd[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            continue
        for name, value in leaves.items():
            if name == "kernel" and value.ndim == 4 and mod in deconvs:
                sd[prefix + "weight"] = _f32(np.transpose(value[::-1, ::-1], (2, 3, 0, 1)))
            elif name == "kernel" and value.ndim == 4:
                sd[prefix + "weight"] = _f32(np.transpose(value, (3, 2, 0, 1)))
            elif name == "kernel" and value.ndim == 2:
                sd[prefix + "weight"] = _f32(value.T)
            elif name == "scale":  # layer norm
                sd[prefix + "weight"] = _f32(value)
            else:  # bias and raw parameters
                sd[prefix + name] = _f32(value)
    return sd


def _is_deconv_path(mod: str) -> bool:
    """Torch-naming heuristic for ConvTranspose modules.

    Matches explicit 'deconv'/'*upsampler' leaves AND an indexed position
    directly inside an upsampler Sequential (e.g. 'decoder3_upsampler.3',
    the terminal ConvTranspose) — but NOT the regular convs nested deeper
    (e.g. 'decoder3_upsampler.0.conv').
    """
    parts = mod.split(".")
    if "deconv" in parts[-1] or "upsampler" in parts[-1]:
        return True
    return parts[-1].isdigit() and len(parts) >= 2 and "upsampler" in parts[-2]


def convert_with_template(
    sd: Mapping[str, Any],
    template: Mapping[str, Any],
    strict: bool = True,
    problems_out: list | None = None,
) -> dict:
    """Convert a torch state dict into the EXACT shape of a flax param tree
    (the JAX package's function, numpy only).

    ``template``'s nesting and leaf names drive the conversion
    (``flax_template`` gives it without flax). Rules per torch leaf:

    * target leaf ``kernel``: 4-D weights become conv (O,I,kh,kw)->(kh,kw,I,O)
      or transposed-conv (I,O,kh,kw)->(kh,kw,I,O)+spatial flip — told apart
      by the template leaf's shape (falling back to a name heuristic when
      I == O makes both fit); 2-D weights transpose (O,I)->(I,O).
    * target leaf ``scale`` (LayerNorm/GroupNorm): copied from torch
      ``weight``.
    * batch-norm leaves and direct parameters (cls_token, pos_embed,
      rel_pos_*) copy verbatim.

    Every converted leaf is float32. strict=True raises with a per-layer
    report when any template leaf is unmatched or any torch tensor is left
    over (num_batches_tracked is always ignored).
    """
    sd = _strip_wrapper_prefixes({k: np.asarray(v) for k, v in sd.items()})
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}

    # Flatten the template: dotted module path -> {leaf name: shape}
    flat_template: dict[str, dict[str, tuple]] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, child in node.items():
            path = f"{prefix}.{name}" if prefix else str(name)
            if hasattr(child, "items"):
                walk(child, path)
            else:
                mod, _, leaf = path.rpartition(".")
                flat_template.setdefault(mod, {})[leaf] = tuple(np.shape(child))

    walk(template, "")

    converted: dict[str, dict[str, np.ndarray]] = {}
    problems: list[str] = []

    def place(mod: str, leaf: str, value: np.ndarray) -> None:
        converted.setdefault(mod, {})[leaf] = value.astype(np.float32)

    for key, w in sd.items():
        mod, _, torch_leaf = key.rpartition(".")
        leaves = flat_template.get(mod)
        if leaves is None:
            problems.append(f"torch module {mod!r} (from {key!r}) has no template match")
            continue
        if torch_leaf == "weight":
            if "kernel" in leaves:
                want = leaves["kernel"]
                if w.ndim == 4:
                    as_conv = np.transpose(w, (2, 3, 1, 0))
                    as_deconv = np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
                    conv_fits = as_conv.shape == want
                    deconv_fits = as_deconv.shape == want
                    if conv_fits and deconv_fits:
                        # I == O: both layouts fit; decide by torch naming
                        is_deconv = _is_deconv_path(mod)
                        place(mod, "kernel", as_deconv if is_deconv else as_conv)
                    elif deconv_fits:
                        place(mod, "kernel", as_deconv)
                    elif conv_fits:
                        place(mod, "kernel", as_conv)
                    else:
                        problems.append(
                            f"{key!r}: no conv layout of {w.shape} fits template {want}"
                        )
                elif w.ndim == 2:
                    place(mod, "kernel", np.transpose(w, (1, 0)))
                else:
                    place(mod, "kernel", w)
            elif "scale" in leaves:
                place(mod, "scale", w)
            elif "weight" in leaves:  # EvalBN keeps torch naming
                place(mod, "weight", w)
            else:
                problems.append(f"{key!r}: template has no kernel/scale/weight leaf")
        elif torch_leaf in leaves:
            place(mod, torch_leaf, w)
        else:
            problems.append(f"{key!r}: leaf {torch_leaf!r} not in template {sorted(leaves)}")

    # verify coverage + shapes
    for mod, leaves in flat_template.items():
        got = converted.get(mod, {})
        for leaf, shape in leaves.items():
            if leaf not in got:
                problems.append(f"template leaf {mod}.{leaf} not filled from torch")
            elif tuple(got[leaf].shape) != shape:
                problems.append(
                    f"{mod}.{leaf}: shape {got[leaf].shape} != template {shape}"
                )
    if problems_out is not None:
        problems_out.extend(problems)
    if problems and strict:
        report = "\n  ".join(problems[:40])
        raise ValueError(f"torch->flax conversion mismatches ({len(problems)}):\n  {report}")

    # re-nest following the template structure
    def rebuild(node: Mapping[str, Any], prefix: str) -> dict:
        out: dict[str, Any] = {}
        for name, child in node.items():
            path = f"{prefix}.{name}" if prefix else str(name)
            if hasattr(child, "items"):
                out[name] = rebuild(child, path)
            else:
                mod, _, leaf = path.rpartition(".")
                out[name] = converted.get(mod, {}).get(leaf, np.asarray(child))
        return out

    return rebuild(template, "")


def conversion_report(sd: Mapping[str, Any], template: Mapping[str, Any]) -> dict:
    """Per-layer mapping coverage of a torch state dict against a flax
    template: how many template leaves filled, how many torch tensors used,
    and every mismatch (the `wsinsight models convert --report` payload)."""
    problems: list[str] = []
    converted = convert_with_template(sd, template, strict=False, problems_out=problems)

    def count_leaves(node) -> int:
        if hasattr(node, "items"):
            return sum(count_leaves(v) for v in node.values())
        return 1

    n_template = count_leaves(template)
    clean_sd = _strip_wrapper_prefixes({k: np.asarray(v) for k, v in sd.items()})
    n_torch = sum(1 for k in clean_sd if not k.endswith("num_batches_tracked"))
    unfilled = sum(1 for pr in problems if "not filled" in pr)
    return {
        "template_leaves": n_template,
        "template_filled": n_template - unfilled,
        "torch_tensors": n_torch,
        "problems": problems,
        "ok": not problems,
        "params": converted,
    }


def _flax_scopes() -> tuple[type, ...]:
    """The port's module classes whose flax counterparts are modules of
    their own, so that their parameters nest one level down in the flax
    tree under the dotted path from the enclosing one. Every other module
    (torch containers, ResNet blocks, HoVer-Net units, ``Mlp``,
    ``PatchEmbed``, ``LayerScale``) has its parameters named with its dotted
    path inside the enclosing scope: the classifiers' flax trees are flat,
    ``name=f"{prefix}.conv1"``."""
    from .cellvit import Conv2DBlock, Deconv2DBlock, UpsamplingBranch
    from .hovernet import HoverDecoder, HoverDenseBlock, ResidualStage
    from .vit import Attention, Block, ViTEncoder

    return (ViTEncoder, Block, Attention, UpsamplingBranch, Conv2DBlock, Deconv2DBlock,
            ResidualStage, HoverDenseBlock, HoverDecoder)


def _flax_leaves(mod: torch.nn.Module, leaf: str, shape: tuple) -> tuple[str, tuple]:
    """(flax leaf name, flax shape) of parameter ``leaf`` of a layer module:
    the inverse of ``flax_params_to_state_dict``'s mapping."""
    if leaf == "weight" and isinstance(mod, torch.nn.ConvTranspose2d):
        return "kernel", (shape[2], shape[3], shape[0], shape[1])
    if leaf == "weight" and isinstance(mod, torch.nn.Conv2d):
        return "kernel", (shape[2], shape[3], shape[1], shape[0])
    if leaf == "weight" and isinstance(mod, torch.nn.Linear):
        return "kernel", (shape[1], shape[0])
    if leaf == "weight" and isinstance(mod, torch.nn.LayerNorm):
        return "scale", shape
    return leaf, shape  # biases, batch-norm leaves


_LAYERS = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear, torch.nn.LayerNorm,
           torch.nn.BatchNorm2d)


def flax_template(architecture: str, num_classes: int, input_size: int | None = None,
                  halo_size: int | None = None) -> dict:
    """The flax ``params`` tree of a registry architecture, without flax:
    its nesting, leaf names and leaf shapes, as ``model.init`` at
    ``input_size`` (default 256 for cell models, 224 otherwise) gives them.
    The port's module is built on the ``meta`` device (no weights
    allocated: CellViT-SAM-H has 728.8 M parameters), and its state dict
    mapped through the inverse of ``flax_params_to_state_dict``; the nesting
    follows ``_flax_scopes``. Leaves are float32 zeros that take no memory
    (broadcast views)."""
    from . import create_model, is_cell_architecture

    kwargs = {}
    if is_cell_architecture(architecture):
        kwargs["img_size"] = input_size or 256
        if halo_size is not None:
            kwargs["halo_size"] = halo_size
    with torch.device("meta"):
        model = create_model(architecture, num_classes, **kwargs)
    scopes = {name for name, m in model.named_modules() if isinstance(m, _flax_scopes())}
    zero = np.zeros((), np.float32)
    tree: dict[str, Any] = {}
    for key, t in model.state_dict(keep_vars=True).items():
        if key.endswith("num_batches_tracked"):
            continue
        path, _, leaf = key.rpartition(".")
        parts = path.split(".") if path else []
        node, start = tree, 0
        for i in range(1, len(parts) + 1):
            if ".".join(parts[:i]) in scopes:
                node = node.setdefault(".".join(parts[start:i]), {})
                start = i
        rest = ".".join(parts[start:])
        mod = model.get_submodule(path)
        if rest and isinstance(mod, _LAYERS):
            name, shape = _flax_leaves(mod, leaf, tuple(t.shape))
            node.setdefault(rest, {})[name] = np.broadcast_to(zero, shape)
        else:  # a raw parameter, of the scope itself or of a plain module in it
            node[f"{rest}.{leaf}" if rest else leaf] = np.broadcast_to(zero, tuple(t.shape))
    return tree


def load_torch_weights(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """A torch checkpoint (.pt/.pth state dict, or TorchScript .pt/.ts) as a
    CPU state dict with wrapper prefixes stripped."""
    try:
        sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive: a pickled state dict
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
    return _strip_wrapper_prefixes({k: v.detach() for k, v in sd.items()})


def load_flax_msgpack(path: str | os.PathLike) -> dict:
    """Read a flax ``msgpack`` checkpoint (``flax.serialization`` format)
    into a nested dict of numpy arrays, without flax."""
    import msgpack

    def ext_hook(code: int, data: bytes):
        if code in (1, 3):  # ndarray, numpy scalar: (shape, dtype name, buffer)
            shape, dtype, buf = msgpack.unpackb(data, raw=True)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
            return arr if code == 1 else arr[()]
        if code == 2:  # complex
            re, im = msgpack.unpackb(data)
            return complex(re, im)
        return msgpack.ExtType(code, data)

    def unchunk(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
                chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
                return np.concatenate(chunks).reshape(shape)
            return {k: unchunk(v) for k, v in node.items()}
        return node

    with open(path, "rb") as fh:
        return unchunk(msgpack.unpackb(fh.read(), ext_hook=ext_hook, raw=False))


def normalize_hovernet_keys(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Rewrite released hover_net state-dict spellings onto the port's names.

    Upstream net_desc.py names submodules with '/' inside its OrderedDict
    Sequentials (the stem conv is literally named '/': 'conv0./.weight';
    batch norms are 'preact/bn', 'conv1/bn', 'conv2/bn', 'preact_bna/bn'),
    and UpSample2x registers a constant 'unpool_mat' buffer. This maps
    'conv0./.' -> 'conv0.conv.', '<x>/bn.' -> '<x>_bn.' and drops the buffer.
    Idempotent on dicts already normalized (TorchScript re-exports may
    sanitize names upstream)."""
    out: dict[str, Any] = {}
    for k, v in sd.items():
        if k.endswith("unpool_mat"):
            continue
        k = k.replace("conv0./.", "conv0.conv.")
        k = k.replace("/bn.", "_bn.")
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# Keras HDF5 -> the port's StarDist (2D_versatile_he), no TensorFlow needed
# ---------------------------------------------------------------------------


def _keras_h5_weights(path: str | os.PathLike) -> list[tuple[str, dict[str, np.ndarray]]]:
    """Parse a Keras ``save_weights`` HDF5 file into ordered
    (layer_name, {leaf: array}) pairs, skipping weightless layers.

    The format: root attr ``layer_names`` lists layers in graph order; each
    layer group's ``weight_names`` attr lists datasets like
    ``<layer>/kernel:0``."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError(
            f"reading the Keras weights file {path} needs h5py, which is not installed;"
            " convert it where h5py is, to stardist_2D_versatile_he.msgpack"
            " (save_flax_msgpack), and place that file instead"
        ) from err

    def _names(attr) -> list[str]:
        return [n.decode() if isinstance(n, bytes) else str(n) for n in attr]

    out: list[tuple[str, dict[str, np.ndarray]]] = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for layer in _names(root.attrs["layer_names"]):
            group = root[layer]
            leaves: dict[str, np.ndarray] = {}
            for wname in _names(group.attrs.get("weight_names", [])):
                leaf = wname.rsplit("/", 1)[-1].split(":", 1)[0]  # kernel:0 -> kernel
                leaves[leaf] = np.asarray(group[wname])
            if leaves:
                out.append((layer, leaves))
    return out


# Layers of the released 2D_versatile_he graph that carry their own names
# (stardist's model2d names the unet_block convs and the heads; the two
# grid-stem convs are anonymous Conv2D layers).
_STARDIST_HE_NAMED = frozenset(
    [f"down_level_{n}_no_{i}" for n in range(3) for i in range(2)]
    + [f"up_level_{n}_no_{i}" for n in range(3) for i in range(2)]
    + ["middle_0", "middle_1", "features", "prob", "dist"]
)
_STARDIST_STEM_SHAPES = [(3, 3, 3, 32), (3, 3, 32, 32)]


def convert_stardist_keras_h5(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """The released StarDist ``2D_versatile_he`` Keras weights file as the
    state dict of the port's ``models.stardist.StarDistUNet``.

    Keras Conv2D kernels are (kh, kw, in, out), flax's layout, so the layers
    form a flax param tree that ``flax_params_to_state_dict`` carries across;
    named layers map by name, and the two anonymous grid-stem convs by their
    position, checked by shape."""
    params: dict[str, dict[str, np.ndarray]] = {}
    stem: list[tuple[str, dict[str, np.ndarray]]] = []
    unexpected: list[str] = []
    for layer, leaves in _keras_h5_weights(path):
        if layer in _STARDIST_HE_NAMED:
            params[layer] = {
                "kernel": np.asarray(leaves["kernel"], np.float32),
                "bias": np.asarray(leaves["bias"], np.float32),
            }
        elif "kernel" in leaves and np.ndim(leaves["kernel"]) == 4:
            stem.append((layer, leaves))
        else:
            unexpected.append(layer)
    if unexpected:
        raise ValueError(f"unrecognized weighted layers in {path}: {unexpected}")
    if len(stem) != len(_STARDIST_STEM_SHAPES):
        raise ValueError(
            f"expected {len(_STARDIST_STEM_SHAPES)} anonymous grid-stem convs,"
            f" found {len(stem)}: {[n for n, _ in stem]}"
        )
    for i, ((layer, leaves), want) in enumerate(zip(stem, _STARDIST_STEM_SHAPES)):
        got = tuple(leaves["kernel"].shape)
        if got != want:
            raise ValueError(f"stem conv {layer}: kernel shape {got}, expected {want}")
        params[f"stem_conv_{i}"] = {
            "kernel": np.asarray(leaves["kernel"], np.float32),
            "bias": np.asarray(leaves["bias"], np.float32),
        }

    missing = _STARDIST_HE_NAMED - params.keys()
    if missing:
        raise ValueError(f"layers missing from {path}: {sorted(missing)}")
    return flax_params_to_state_dict(params)


def save_flax_msgpack(params: Mapping[str, Any], path: str | os.PathLike) -> str:
    """Write a nested dict of arrays in flax's msgpack checkpoint format (what
    ``flax.serialization.msgpack_serialize`` writes, and ``load_flax_msgpack``
    and the JAX package read), without flax: keys sorted as flax sorts them,
    so the bytes are flax's for arrays under flax's 1 GiB chunk size. Returns
    the file's sha256."""
    import msgpack

    def ext(x):
        if isinstance(x, np.ndarray):  # flax's ndarray extension: (shape, dtype, bytes)
            data = msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True)
            return msgpack.ExtType(1, data)
        return x

    def tree(node):
        if hasattr(node, "items"):
            return {str(k): tree(v) for k, v in sorted(node.items())}
        return np.asarray(node.detach().cpu() if isinstance(node, torch.Tensor) else node)

    data = msgpack.packb(tree(params), default=ext, strict_types=True)
    with open(path, "wb") as fh:
        fh.write(data)
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str | os.PathLike) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
