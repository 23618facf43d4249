"""A WSInfer patch classifier as its reference pipeline runs it: the PIL
bilinear resize of each uint8 patch (torchvision's Resize on a PIL image),
ToTensor and Normalize, torchvision's ResNet in float32, and the softmax.
Weights come as a torchvision-named state dict."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from .numerics import cast, exact_float32


def preprocess(patches: np.ndarray, size: int, mean, std, device) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, size, size) float32, normalized."""
    resized = np.stack([np.asarray(Image.fromarray(p).resize((size, size), Image.BILINEAR))
                        for p in patches])
    x = torch.from_numpy(resized).to(device).permute(0, 3, 1, 2).float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=device).view(1, 3, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=device).view(1, 3, 1, 1)
    return (x - m) / s


def _bn(x, sd, key):
    scale = sd[f"{key}.weight"] * torch.rsqrt(sd[f"{key}.running_var"] + 1e-5)
    shift = sd[f"{key}.bias"] - sd[f"{key}.running_mean"] * scale
    return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def _conv(x, w, stride, padding, precision):
    return F.conv2d(cast(x, precision), cast(w, precision), stride=stride, padding=padding)


def resnet_logits(x: torch.Tensor, sd: dict, layers, precision: str = "float32") -> torch.Tensor:
    """torchvision's BasicBlock ResNet on (N, 3, H, W)."""
    pooled = resnet_features(x, sd, layers, precision)
    with exact_float32():
        return F.linear(cast(pooled, precision), cast(sd["fc.weight"], precision),
                        sd["fc.bias"].float())


def resnet_features(x: torch.Tensor, sd: dict, layers, precision: str = "float32") -> torch.Tensor:
    """The pooled features (N, C) that the ResNet's head reads."""
    with exact_float32():
        y = torch.relu(_bn(_conv(x, sd["conv1.weight"], 2, 3, precision), sd, "bn1"))
        y = F.max_pool2d(y, 3, 2, 1)
        for li, blocks in enumerate(layers):
            for bi in range(blocks):
                p = f"layer{li + 1}.{bi}"
                stride = 2 if li and not bi else 1
                if f"{p}.downsample.0.weight" in sd:
                    identity = _bn(_conv(y, sd[f"{p}.downsample.0.weight"], stride, 0, precision),
                                   sd, f"{p}.downsample.1")
                else:
                    identity = y
                z = torch.relu(_bn(_conv(y, sd[f"{p}.conv1.weight"], stride, 1, precision),
                                   sd, f"{p}.bn1"))
                z = _bn(_conv(z, sd[f"{p}.conv2.weight"], 1, 1, precision), sd, f"{p}.bn2")
                y = torch.relu(z + identity)
        return y.mean(dim=(2, 3))


def probabilities(patches: np.ndarray, sd: dict, cfg: dict, device,
                  precision: str = "float32", block: int = 128) -> np.ndarray:
    """(N, K) softmax probabilities of uint8 patches, ``block`` at a time."""
    out = []
    for i in range(0, len(patches), block):
        x = preprocess(patches[i:i + block], cfg["resize"], cfg["mean"], cfg["std"], device)
        out.append(torch.softmax(resnet_logits(x, sd, cfg["layers"], precision), 1).cpu())
    return torch.cat(out).numpy()
