"""HoVer-Net (fast / PanNuke) in torch, spatially faithful to the released graph.

Counterpart of wsinsight_tpu/models/hovernet.py, with the same module names
(``conv0.conv``, ``d0.units.0.conv1_bn``, ``d0.blk_bna.bn``,
``decoder.np.u3.dense.units.0.preact_bna_bn``, ``decoder.tp.u0.conv``, ...) so
a flax param tree carried across by ``flax_params_to_state_dict``, and a
released state dict after ``convert.normalize_hovernet_keys``, load with
``strict=True``.

* encoder: the 7x7 stem (conv0), then four residual blocks d0..d3 (3/4/6/3
  bottleneck units, widths 64/128/256/512, strides 1/2/2/2): one 1x1
  shortcut conv at block entry (then the running sum), no preact on the
  first unit, a trailing bn-relu (``blk_bna``); the stride-2 3x3 convs pad
  TF-SAME, (0, 1) on the even sizes the input check guarantees;
* ``conv_bot`` 1x1 2048 -> 1024 on d3;
* three decoders (np / hv / tp), fast mode, with VALID 3x3 convs: u3 =
  up2(d3) + d2 -> conva -> 8 dense units -> convf; u2 = up2 + d1 cropped by
  36 px -> conva -> 4 dense units -> convf; u1 = up2 + d0 cropped by 92 px
  -> conva (the one SAME decoder conv); u0 = bn-relu-conv1x1 with bias;
* a dense unit is bn-relu-conv1x1(128) -> bn-relu-conv3x3 VALID (32 out,
  groups=4); the stack is centre-cropped 1 px a side before the concat.

The VALID arithmetic makes the maps input - 92 px: a built-in 46 px halo. A
larger ``halo_size`` crops the extra margin. Layout at the public surface is
the JAX package's: ``forward`` takes NHWC (B, H, W, 3) float images and
returns channel-first float32 maps ``nuclei_binary_map`` (B, 2, O, O),
``hv_map`` (B, 2, O, O) and ``nuclei_type_map`` (B, K, O, O), O = H -
2*halo. Inside, tensors are NCHW in channels_last memory. Parameters are
float32; ``dtype`` is the compute dtype (bfloat16 runs under autocast).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, EvalBN, compute_in

# The decoder's VALID convs shrink the input by 92 px: 46 a side.
INTRINSIC_HALO = 46


def tf_same_pads(size_h: int, size_w: int, ksize: int, stride: int):
    """TF-SAME per-side padding, as hover_net's TFSamepaddingLayer computes it
    (asymmetric: the extra pixel goes at the END, (0, 1) for 3x3/s2 on even
    inputs, where torch's padding=1 would pad (1, 1) and shift the grid)."""

    def one(size: int) -> tuple[int, int]:
        if size % stride == 0:
            pad = max(ksize - stride, 0)
        else:
            pad = max(ksize - (size % stride), 0)
        return pad // 2, pad - pad // 2

    return one(size_h), one(size_w)


class _BnRelu(nn.Module):
    """``blk_bna``: batch norm then ReLU (its batch norm is ``blk_bna.bn``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.bn = EvalBN(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(x))


class _ResidualUnit(nn.Module):
    """[preact bn-relu] -> conv1x1 -> bn-relu -> conv3x3/s -> bn-relu ->
    conv1x1 (x4 width). The first unit of a block has no preact: the
    previous block's ``blk_bna`` (or conv0's bn) already normalized."""

    def __init__(self, in_ch: int, width: int, stride: int, first: bool):
        super().__init__()
        self.preact_bn = None if first else EvalBN(in_ch)
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.conv1_bn = EvalBN(width)
        # even sizes only (HoVerNetFast checks): TF-SAME is (1, 1) at stride
        # 1 and (0, 1) at stride 2 (tf_same_pads)
        pad = 1 if stride == 1 else ((0, 1), (0, 1))
        self.conv2 = Conv2d(width, width, 3, stride, pad, bias=False)
        self.conv2_bn = EvalBN(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.preact_bn is not None:
            x = torch.relu(self.preact_bn(x))
        x = torch.relu(self.conv1_bn(self.conv1(x)))
        x = torch.relu(self.conv2_bn(self.conv2(x)))
        return self.conv3(x)


class ResidualStage(nn.Module):
    """One encoder block (d0..d3): block-entry shortcut, first-unit preact
    skip, trailing ``blk_bna``."""

    def __init__(self, in_ch: int, width: int, n_units: int, stride: int = 1):
        super().__init__()
        out_ch = width * 4
        self.shortcut = None
        if stride != 1 or in_ch != out_ch:
            self.shortcut = Conv2d(in_ch, out_ch, 1, stride, bias=False)
        self.units = nn.ModuleList(
            _ResidualUnit(in_ch if j == 0 else out_ch, width, stride if j == 0 else 1, j == 0)
            for j in range(n_units)
        )
        self.blk_bna = _BnRelu(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        for unit in self.units:
            x = unit(x) + shortcut
            shortcut = x
        return self.blk_bna(x)


class _DenseUnit(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.preact_bna_bn = EvalBN(in_ch)
        self.conv1 = Conv2d(in_ch, 128, 1, bias=False)
        self.conv1_bn = EvalBN(128)
        self.conv2 = Conv2d(128, 32, 3, bias=False, groups=4)  # VALID: shrinks 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.preact_bna_bn(x)))
        y = self.conv2(torch.relu(self.conv1_bn(y)))
        return torch.cat([x[:, :, 1:-1, 1:-1], y], dim=1)


class HoverDenseBlock(nn.Module):
    """Dense units (+32 channels each) on a stack centre-cropped to each
    unit's output, then a trailing bn-relu."""

    def __init__(self, in_ch: int, n_units: int):
        super().__init__()
        self.units = nn.ModuleList(_DenseUnit(in_ch + 32 * j) for j in range(n_units))
        self.blk_bna = _BnRelu(in_ch + 32 * n_units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.units:
            x = unit(x)
        return self.blk_bna(x)


class _UpStage(nn.Module):
    """u3 / u2: conva 3x3 VALID -> dense block -> convf 1x1."""

    def __init__(self, in_ch: int, mid: int, n_dense: int, out_ch: int):
        super().__init__()
        self.conva = Conv2d(in_ch, mid, 3, bias=False)
        self.dense = HoverDenseBlock(mid, n_dense)
        self.convf = Conv2d(mid + 32 * n_dense, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convf(self.dense(self.conva(x)))


class _U1(nn.Module):
    def __init__(self):
        super().__init__()
        self.conva = Conv2d(256, 64, 3, padding=1, bias=False)  # the SAME one

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conva(x)


class _U0(nn.Module):
    def __init__(self, out_channels: int):
        super().__init__()
        self.bn = EvalBN(64)
        self.conv = Conv2d(64, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.bn(x)))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling (each pixel becomes a 2x2 block)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class HoverDecoder(nn.Module):
    """One branch (fast mode, ksize 3): u3 -> u2 -> u1 -> u0; takes the
    PRE-CROPPED d0 / d1 skips (92 / 36 px in all)."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.u3 = _UpStage(1024, 256, 8, 512)
        self.u2 = _UpStage(512, 128, 4, 256)
        self.u1 = _U1()
        self.u0 = _U0(out_channels)

    def forward(self, d0c, d1c, d2, d3) -> torch.Tensor:
        x = self.u3(_up2(d3) + d2)
        x = self.u2(_up2(x) + d1c)
        x = self.u1(_up2(x) + d0c)
        return self.u0(x)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 64, 7, 1, 3, bias=False)  # TF-SAME 7x7/1 is (3, 3)
        self.bn = EvalBN(64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class HoVerNetFast(nn.Module):
    """HoVer-Net fast with NP / HV / TP branches.

    ``img_size`` is the patch side the engine runs it at (the model has no
    size-bound parameters: any side divisible by 8 and >= 96 works)."""

    def __init__(self, num_nuclei_classes: int = 6, halo_size: int = INTRINSIC_HALO,
                 dtype: torch.dtype = torch.float32, img_size: int = 256):
        super().__init__()
        self.dtype = dtype
        self.halo_size = halo_size
        self.img_size = img_size
        self.conv0 = _Stem()
        in_ch = 64
        for i, (width, n_units) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3))):
            setattr(self, f"d{i}", ResidualStage(in_ch, width, n_units, 1 if i == 0 else 2))
            in_ch = width * 4
        self.conv_bot = Conv2d(2048, 1024, 1, bias=False)
        self.decoder = nn.ModuleDict({
            "np": HoverDecoder(2),
            "hv": HoverDecoder(2),
            "tp": HoverDecoder(num_nuclei_classes),
        })

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, H, W, 3) float, already preprocessed."""
        if self.halo_size < INTRINSIC_HALO:
            raise ValueError(
                "hover_net fast has an intrinsic 46 px halo (VALID decoder "
                f"shrinks input by 92); halo_size={self.halo_size} < 46"
            )
        if x.shape[1] % 8 or x.shape[2] % 8 or min(x.shape[1], x.shape[2]) < 96:
            raise ValueError(
                f"input {x.shape[1]}x{x.shape[2]} must be divisible by 8 and "
                ">= 96 for the VALID decoder arithmetic"
            )
        with compute_in(self.dtype, x):
            y = self.conv0(x.permute(0, 3, 1, 2))
            # no stem pooling: d0 runs at full resolution, d3 at H/8
            d0 = self.d0(y)
            d1 = self.d1(d0)
            d2 = self.d2(d1)
            d3 = self.conv_bot(self.d3(d2))
            # fast-mode crop bookkeeping (92 / 36 px in all)
            d0c = d0[:, :, 46:-46, 46:-46]
            d1c = d1[:, :, 18:-18, 18:-18]
            maps = {key: self.decoder[name](d0c, d1c, d2, d3) for key, name in (
                ("nuclei_binary_map", "np"), ("hv_map", "hv"), ("nuclei_type_map", "tp"))}
        extra = self.halo_size - INTRINSIC_HALO
        out = {}
        for key, m in maps.items():
            if extra > 0:
                m = m[:, :, extra:-extra, extra:-extra]
            out[key] = m.float().contiguous()
        return out


def hovernet_fast(num_classes: int, halo_size: int = INTRINSIC_HALO,
                  dtype: torch.dtype = torch.float32, img_size: int = 256) -> HoVerNetFast:
    return HoVerNetFast(num_nuclei_classes=num_classes, halo_size=halo_size, dtype=dtype,
                        img_size=img_size)
