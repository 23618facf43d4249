"""The FLOP of one patch through each configuration's model, from its
published shapes: 2 FLOP per multiply-add of every convolution, transposed
convolution, linear layer and attention product. Norms, activations,
pooling and the softmax are left out, so a share of the peak built on these
counts can only read low."""

from __future__ import annotations


def conv(cin: int, cout: int, k: int, hout: int, wout: int) -> float:
    return 2.0 * cin * cout * k * k * hout * wout


def deconv2(cin: int, cout: int, hin: int, win: int) -> float:
    """A 2x2 stride-2 transposed convolution: each input pixel gives a 2x2
    block of outputs."""
    return 2.0 * cin * cout * 4 * hin * win


def resnet_flops(layers, img: int, num_classes: int, bottleneck: bool = False) -> float:
    """torchvision's ResNet (BasicBlock for ResNet34) at img x img."""
    if bottleneck:
        raise NotImplementedError("only BasicBlock ResNets are counted")
    s = (img + 2 * 3 - 7) // 2 + 1  # conv1, 7x7 stride 2
    total = conv(3, 64, 7, s, s)
    s = (s + 2 - 3) // 2 + 1  # max pool 3x3 stride 2
    cin, width = 64, 64
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            stride = 2 if li and not bi else 1
            so = (s - 1) // stride + 1
            total += conv(cin, width, 3, so, so) + conv(width, width, 3, so, so)
            if stride != 1 or cin != width:
                total += conv(cin, width, 1, so, so)
            cin, s = width, so
        width *= 2
    return total + 2.0 * cin * num_classes


def sam_encoder_flops(embed_dim: int, depth: int, num_heads: int, window: int,
                      n_global: int, mlp_ratio: float, patch: int, img: int) -> float:
    """SAM's ViT encoder over one img x img patch: the patch embedding, and
    per block the qkv and output projections and the MLP on the real token
    grid, QK^T and PV of each real query row against its window's keys (the
    whole grid in a global block), and the rel-pos terms."""
    c, g = embed_dim, img // patch
    t = g * g
    hidden = int(c * mlp_ratio)
    total = conv(3, c, patch, g, g)
    dense = 2.0 * t * c * 3 * c + 2.0 * t * c * c + 2.0 * 2 * t * c * hidden
    windowed = 4.0 * t * window * window * c + 2.0 * t * 2 * window * c
    global_ = 4.0 * t * t * c + 2.0 * t * 2 * g * c
    return total + depth * dense + (depth - n_global) * windowed + n_global * global_


def cellvit_branch_flops(embed_dim: int, img: int, out_channels: int) -> float:
    """One CellViT decoder branch (nuclei binary map, HV map or type map)
    from the four /16 skips and the image to out_channels maps at img px."""
    c, g = embed_dim, img // 16
    bottleneck, skip11, skip12 = (312, 256, 128) if c < 512 else (512, 512, 256)

    def block(cin, cout, s):  # Conv2DBlock: 3x3 conv at s x s
        return conv(cin, cout, 3, s, s)

    def deblock(cin, cout, s):  # Deconv2DBlock: s -> 2s, then a 3x3 conv
        return deconv2(cin, cout, s, s) + conv(cout, cout, 3, 2 * s, 2 * s)

    total = deconv2(c, bottleneck, g, g) + deblock(c, bottleneck, g)
    total += block(2 * bottleneck, bottleneck, 2 * g) + 2 * block(bottleneck, bottleneck, 2 * g)
    total += deconv2(bottleneck, 256, 2 * g, 2 * g)
    total += deblock(c, skip11, g) + deblock(skip11, 256, 2 * g)
    total += block(512, 256, 4 * g) + block(256, 256, 4 * g) + deconv2(256, 128, 4 * g, 4 * g)
    total += deblock(c, skip11, g) + deblock(skip11, skip12, 2 * g) + deblock(skip12, 128, 4 * g)
    total += block(256, 128, 8 * g) + block(128, 128, 8 * g) + deconv2(128, 64, 8 * g, 8 * g)
    total += block(3, 32, img) + block(32, 64, img)
    total += block(128, 64, img) + block(64, 64, img) + conv(64, out_channels, 1, img, img)
    return total


def cellvit_sam_flops(w: dict) -> float:
    """CellViT with a SAM encoder over one patch, from a configuration's
    ``widths``: the encoder, the three decoder branches (2, 2 and the nuclei
    classes) and the tissue head."""
    img, c = w["patch_size_pixels"], w["embed_dim"]
    total = sam_encoder_flops(c, w["depth"], w["num_heads"], w["window_size"],
                              len(w["global_attn_indexes"]), w["mlp_ratio"],
                              w["patch_size"], img)
    for out in (2, 2, w["num_nuclei_classes"]):
        total += cellvit_branch_flops(c, img, out)
    return total + 2.0 * c * w["num_tissue_classes"]
