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


def sha256_file(path: str | os.PathLike) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
