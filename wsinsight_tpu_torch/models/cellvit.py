"""CellViT nucleus instance segmentation in torch (SAM, ViT-256 and Virchow
variants).

Counterpart of wsinsight_tpu/models/cellvit.py, with the same module names
(``encoder``, ``nuclei_binary_map_decoder.decoder3.0.deconv``, ...) so a flax
param tree carried across by ``flax_params_to_state_dict`` loads with
``strict=True``. A ViT encoder gives skip features at four depths (a /14
encoder's, Virchow's, resized to the /16 grid the decoder needs); three
U-Net-style upsampling branches (nuclei binary map, HV map, nuclei type
map) decode them with 2x2 transposed convolutions; a linear head classifies
the tissue from the pooled token.

Layout at the public surface is the JAX package's: ``forward`` takes NHWC
(B, H, W, 3) normalised images and returns channel-first float32 maps
``nuclei_binary_map`` (B, 2, O, O), ``hv_map`` (B, 2, O, O) and
``nuclei_type_map`` (B, K, O, O), O = H - 2*halo, plus ``tissue_types``
logits. Inside, the decoder runs NCHW tensors in channels_last memory.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_axis
from .layers import Conv2d, ConvTranspose, EvalBN, compute_in
from .vit import SAM_VIT_B, SAM_VIT_H, SAM_VIT_L, VIRCHOW_VIT_H, VIT_256, ViTConfig, ViTEncoder


class Conv2DBlock(nn.Module):
    """conv3x3 + bn + relu (CellViT Conv2DBlock)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, 1, 1)
        self.bn = EvalBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class Deconv2DBlock(nn.Module):
    """convtranspose2x2(s2) + conv3x3 + bn + relu (CellViT Deconv2DBlock)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.deconv = ConvTranspose(in_ch, out_ch)
        self.conv = Conv2d(out_ch, out_ch, 3, 1, 1)
        self.bn = EvalBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(self.deconv(x))))


class UpsamplingBranch(nn.Module):
    """One decoder branch: z4..z1 skips + input image -> (B, out, H, W).

    Widths follow upstream CellViT: bottleneck/skip widths 512/512/256 for
    the SAM encoders and 312/256/128 for the ViT-256 encoder
    (``cellvit.py:88-91`` of the JAX package); terminal widths 256/128/64.
    """

    def __init__(self, out_channels: int, embed_dim: int):
        super().__init__()
        if embed_dim < 512:  # ViT-256 encoder
            bottleneck, skip11, skip12 = 312, 256, 128
        else:  # SAM encoders
            bottleneck, skip11, skip12 = 512, 512, 256
        seq = nn.Sequential
        self.bottleneck_upsampler = ConvTranspose(embed_dim, bottleneck)
        self.decoder3 = seq(Deconv2DBlock(embed_dim, bottleneck))
        self.decoder3_upsampler = seq(
            Conv2DBlock(2 * bottleneck, bottleneck), Conv2DBlock(bottleneck, bottleneck),
            Conv2DBlock(bottleneck, bottleneck), ConvTranspose(bottleneck, 256),
        )
        self.decoder2 = seq(Deconv2DBlock(embed_dim, skip11), Deconv2DBlock(skip11, 256))
        self.decoder2_upsampler = seq(
            Conv2DBlock(512, 256), Conv2DBlock(256, 256), ConvTranspose(256, 128),
        )
        self.decoder1 = seq(
            Deconv2DBlock(embed_dim, skip11), Deconv2DBlock(skip11, skip12),
            Deconv2DBlock(skip12, 128),
        )
        self.decoder1_upsampler = seq(
            Conv2DBlock(256, 128), Conv2DBlock(128, 128), ConvTranspose(128, 64),
        )
        self.decoder0 = seq(Conv2DBlock(3, 32), Conv2DBlock(32, 64))
        self.decoder0_header = seq(
            Conv2DBlock(128, 64), Conv2DBlock(64, 64), Conv2d(64, out_channels, 1),
        )

    def forward(self, img, z1, z2, z3, z4) -> torch.Tensor:
        """All inputs NCHW; the skips are the (B, C, H/16, W/16) grids."""
        y = torch.cat([self.decoder3(z3), self.bottleneck_upsampler(z4)], 1)  # 16 -> 32
        y = self.decoder3_upsampler(y)  # 32 -> 64
        y = self.decoder2_upsampler(torch.cat([self.decoder2(z2), y], 1))  # 64 -> 128
        y = self.decoder1_upsampler(torch.cat([self.decoder1(z1), y], 1))  # 128 -> 256
        return self.decoder0_header(torch.cat([self.decoder0(img), y], 1))


_VARIANTS: dict[str, ViTConfig] = {
    "sam-b": SAM_VIT_B,
    "sam-l": SAM_VIT_L,
    "sam-h": SAM_VIT_H,
    "256": VIT_256,
    "virchow": VIRCHOW_VIT_H,
}


class CellViT(nn.Module):
    """CellViT with NP/HV/TP branches and tissue classifier.

    ``img_size`` is the patch side the model runs at (it fixes the encoder's
    pos_embed and rel-pos shapes); ``config_override`` replaces the
    variant's ViTConfig (small test configs)."""

    def __init__(self, variant: str = "sam-h", num_nuclei_classes: int = 6,
                 num_tissue_classes: int = 19, halo_size: int = 46,
                 dtype: torch.dtype = torch.float32, config_override: ViTConfig | None = None,
                 img_size: int = 256):
        super().__init__()
        if img_size % 16:
            raise ValueError(f"CellViT needs a patch side divisible by 16, got {img_size}")
        cfg = config_override or _VARIANTS[variant]
        self.encoder = ViTEncoder(cfg, img_size)
        self.dtype = dtype
        self.halo_size = halo_size
        self.img_size = img_size
        d = cfg.embed_dim
        self.nuclei_binary_map_decoder = UpsamplingBranch(2, d)
        self.hv_map_decoder = UpsamplingBranch(2, d)
        self.nuclei_type_maps_decoder = UpsamplingBranch(num_nuclei_classes, d)
        self.classifier_head = nn.Linear(d, num_tissue_classes)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, H, W, 3) float, already normalised."""
        with compute_in(self.dtype, x):
            _, skips, pooled = self.encoder(x)
            if self.encoder.config.patch_size != 16:
                # /14 backbones (Virchow) feed the /16 decoder: each skip grid
                # is resized to H/16 x W/16 with jax.image.resize's bilinear
                # kernel, antialiased where it shrinks (18 -> 16 at 256 px)
                gh, gw = x.shape[1] // 16, x.shape[2] // 16
                skips = [resize_axis(resize_axis(z, 1, gh), 2, gw) for z in skips]
            z1, z2, z3, z4 = (z.permute(0, 3, 1, 2) for z in skips)
            img = x.permute(0, 3, 1, 2)
            maps = {
                "nuclei_binary_map": self.nuclei_binary_map_decoder(img, z1, z2, z3, z4),
                "hv_map": self.hv_map_decoder(img, z1, z2, z3, z4),
                "nuclei_type_map": self.nuclei_type_maps_decoder(img, z1, z2, z3, z4),
            }
            tissue = self.classifier_head(pooled)
        h = self.halo_size
        out = {}
        for key, m in maps.items():
            if h > 0:
                m = m[:, :, h:-h, h:-h]
            out[key] = m.float().contiguous()
        out["tissue_types"] = tissue.float()
        return out


def _cellvit(variant: str):
    def build(num_classes: int, halo_size: int = 46, dtype: torch.dtype = torch.float32,
              img_size: int = 256) -> CellViT:
        return CellViT(variant=variant, num_nuclei_classes=num_classes, halo_size=halo_size,
                       dtype=dtype, img_size=img_size)

    build.__name__ = f"cellvit_{variant.replace('-', '_')}"
    return build


cellvit_sam_h = _cellvit("sam-h")
cellvit_sam_l = _cellvit("sam-l")
cellvit_sam_b = _cellvit("sam-b")
cellvit_256 = _cellvit("256")


cellvit_virchow = _cellvit("virchow")
