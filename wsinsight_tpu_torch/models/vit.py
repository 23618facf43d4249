"""ViT encoders for CellViT: SAM-style (windowed attention + decomposed
relative positions) and the standard ViT-256 (HIPT), in torch.

Counterpart of wsinsight_tpu/models/vit.py. Module names are the flax
names (``patch_embed.proj``, ``blocks.N.attn.qkv``, ``mlp.lin1``), so a flax
param tree carried across by ``flax_params_to_state_dict`` loads with
``strict=True``. Activations stay in the JAX layout, channel-last
``(B, H, W, C)`` token grids. Parameters are float32; ``dtype`` is the
compute dtype, bfloat16 running under autocast.

On the card every attention core is K2 (``ops.flash_attn.window_attention``);
on the CPU the same call runs its plain version. The port has no switch for
it. The DINOv2 lineage (Virchow's ViT-H/14 behind CellViT-Virchow, and the
H-Optimus-0 ``FoundationViT``) adds a SwiGLU-packed MLP, LayerScale, a
pos-embed kept at the checkpoint's native grid and resampled to the runtime
grid with ``jax.image.resize``'s antialiased bilinear kernel, and register
tokens; its blocks attend globally over the (B, 1, n, C) token row, as
ViT-256's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attn import window_attention
from ..ops.resize import resize_axis
from .layers import LayerNorm, compute_in


@dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 16
    mlp_ratio: float = 4.0
    window_size: int = 14  # SAM variants; 0 = all-global
    global_attn_indexes: tuple = ()
    use_rel_pos: bool = False  # SAM decomposed relative positions
    use_cls_token: bool = True  # standard ViT; SAM has none
    extract_layers: tuple = ()
    # torch leaf naming of the block MLP: SAM exports lin1/lin2, DINO/HIPT
    # (the CellViT-256 encoder lineage) exports fc1/fc2.
    mlp_naming: tuple = ("mlp.lin1", "mlp.lin2")
    # DINOv2-lineage extensions (Virchow, H-Optimus): SwiGLU-packed MLP,
    # LayerScale (ls1/ls2 gamma), a pos-embed at the checkpoint's native grid
    # (0 = at the runtime grid), register tokens after cls, and a pos-embed
    # over the patch grid only (no_embed_class).
    mlp_type: str = "gelu"  # "gelu" | "swiglu"
    layer_scale: bool = False
    native_grid: int = 0
    reg_tokens: int = 0
    no_embed_class: bool = False


SAM_VIT_B = ViTConfig(768, 12, 12, use_rel_pos=True, use_cls_token=False,
                      global_attn_indexes=(2, 5, 8, 11), extract_layers=(3, 6, 9, 12))
SAM_VIT_L = ViTConfig(1024, 24, 16, use_rel_pos=True, use_cls_token=False,
                      global_attn_indexes=(5, 11, 17, 23), extract_layers=(6, 12, 18, 24))
SAM_VIT_H = ViTConfig(1280, 32, 16, use_rel_pos=True, use_cls_token=False,
                      global_attn_indexes=(7, 15, 23, 31), extract_layers=(8, 16, 24, 32))
VIT_256 = ViTConfig(384, 12, 6, use_rel_pos=False, use_cls_token=True,
                    window_size=0, extract_layers=(3, 6, 9, 12),
                    mlp_naming=("mlp.fc1", "mlp.fc2"))
# Virchow (ViT-H/14, DINOv2; the encoder of CellViT-Virchow-x40-AMP): SwiGLU
# hidden int(1280 * 5.3375) = 6832, LayerScale, cls token, global blocks,
# native grid 16 (224/14), skips every 8 blocks.
VIRCHOW_VIT_H = ViTConfig(1280, 32, 16, patch_size=14, mlp_ratio=5.3375,
                          window_size=0, use_rel_pos=False, use_cls_token=True,
                          extract_layers=(8, 16, 24, 32),
                          mlp_naming=("mlp.fc1", "mlp.fc2"),
                          mlp_type="swiglu", layer_scale=True, native_grid=16)
# H-Optimus-0 (timm vit_giant_patch14_reg4_dinov2): SwiGLU hidden 4096,
# LayerScale, 4 register tokens, pos-embed over the patch grid only, 224 px.
HOPTIMUS_VIT_G = ViTConfig(1536, 40, 24, patch_size=14, mlp_ratio=4096 / 1536,
                           window_size=0, use_rel_pos=False, use_cls_token=True,
                           mlp_naming=("mlp.fc1", "mlp.fc2"),
                           mlp_type="swiglu", layer_scale=True, native_grid=16,
                           reg_tokens=4, no_embed_class=True)

def resample_pos_grid(pos_grid: torch.Tensor, ng: int, gh: int, gw: int) -> torch.Tensor:
    """(1, ng*ng, C) pos-embed grid -> (1, gh*gw, C): ``jax.image.resize``'s
    bilinear kernel (antialiased when it shrinks), the DINOv2 convention for
    a runtime grid other than the checkpoint's. Float32."""
    if (gh, gw) == (ng, ng):
        return pos_grid
    c = pos_grid.shape[-1]
    grid = resize_axis(resize_axis(pos_grid.reshape(1, ng, ng, c), 1, gh), 2, gw)
    return grid.reshape(1, gh * gw, c)


def _rel_index(q_size: int, k_size: int) -> np.ndarray:
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return relative.astype(np.int64)


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Slice/interpolate relative position embeddings (SAM get_rel_pos):
    (L, C) -> (q_size, k_size, C), resized along L with ``jax.image.resize``'s
    antialiased linear kernel when L is not 2*max(q, k) - 1."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    rel_pos = resize_axis(rel_pos, 0, max_rel_dist)
    idx = torch.from_numpy(_rel_index(q_size, k_size)).to(rel_pos.device)
    return rel_pos[idx]


class Attention(nn.Module):
    """Multi-head attention with optional SAM decomposed rel-pos, on (B,H,W,C).

    As in the JAX package, the qkv and proj projections run on the REAL
    token grid and only the attention core sees padded windows: zero rows
    through a Linear come out as its bias, so the pad region of the padded
    qkv grid is filled with the qkv bias instead of being projected.
    ``input_size`` is the token grid the model runs at; it fixes the
    rel-pos tables' shapes (2*a - 1, head_dim), a = window or grid side.
    """

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = False,
                 window_size: int = 0, input_size: tuple[int, int] = (16, 16)):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.window_size = window_size
        self.use_rel_pos = use_rel_pos
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if use_rel_pos:
            ah, aw = (window_size, window_size) if window_size else input_size
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * ah - 1, self.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * aw - 1, self.head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.qkv(x)  # (b, h, w, 3*dim)
        ws = self.window_size
        if ws:
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            if (hp, wp) != (h, w):
                padded = self.qkv.bias.to(qkv.dtype).expand(b, hp, wp, 3 * self.dim).clone()
                padded[:, :h, :w] = qkv
                qkv = padded
            ah = aw = ws
        else:
            ah, aw = h, w
        rh = rw = None
        if self.use_rel_pos:
            rh = _get_rel_pos(ah, ah, self.rel_pos_h).to(qkv.dtype)
            rw = _get_rel_pos(aw, aw, self.rel_pos_w).to(qkv.dtype)
        out = window_attention(qkv.contiguous(), self.num_heads, ws, self.scale, rh, rw,
                               valid=(h, w))
        return self.proj(out[:, :h, :w])


class Mlp(nn.Module):
    """Block MLP under the checkpoint's leaf names (``lin1``/``lin2`` or
    ``fc1``/``fc2``): Linear -> exact GELU -> Linear, or with ``swiglu``
    the JAX package's packed SwiGLU: one first Linear to 2*hidden, the gate
    its FIRST half, ``silu(y1) * y2`` -> Linear."""

    def __init__(self, dim: int, hidden: int, names: tuple[str, str], swiglu: bool = False):
        super().__init__()
        self.names = names
        self.swiglu = swiglu
        setattr(self, names[0], nn.Linear(dim, 2 * hidden if swiglu else hidden))
        setattr(self, names[1], nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, self.names[0])(x)
        if self.swiglu:
            y1, y2 = y.chunk(2, dim=-1)
            y = F.silu(y1) * y2
        else:
            y = F.gelu(y)
        return getattr(self, self.names[1])(y)


class LayerScale(nn.Module):
    """DINOv2 LayerScale: a per-channel gain, float32, applied in the
    branch's dtype (flax casts it to the activations' dtype)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))  # flax's init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm transformer block; windowed when window_size > 0."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 use_rel_pos: bool, mlp_naming: tuple = ("mlp.lin1", "mlp.lin2"),
                 input_size: tuple[int, int] = (16, 16), mlp_type: str = "gelu",
                 layer_scale: bool = False):
        super().__init__()
        prefix = {n.split(".")[0] for n in mlp_naming}
        if prefix != {"mlp"}:
            raise ValueError(f"MLP leaves must sit under 'mlp.', got {mlp_naming}")
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, use_rel_pos, window_size, input_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), tuple(n.split(".", 1)[1] for n in mlp_naming),
                       swiglu=mlp_type == "swiglu")
        self.ls1 = LayerScale(dim) if layer_scale else nn.Identity()
        self.ls2 = LayerScale(dim) if layer_scale else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def _global_block(cfg: ViTConfig, n_tokens: int) -> Block:
    """A block of the cls-token lineage: global attention over the token row."""
    return Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, 0, False, cfg.mlp_naming,
                 (1, n_tokens), cfg.mlp_type, cfg.layer_scale)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class ViTEncoder(nn.Module):
    """ViT backbone emitting skip features at config.extract_layers.

    ``forward`` takes (B, H, W, 3) and returns (final grid, [skips], pooled),
    each grid (B, H/p, W/p, C) for patch side p, as the JAX encoder does.
    ``img_size`` is the input side the model runs at (it fixes pos_embed,
    unless the config keeps it at a native grid, and the global blocks'
    rel-pos tables).
    """

    def __init__(self, config: ViTConfig, img_size: int = 256):
        super().__init__()
        cfg = self.config = config
        g = img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        if cfg.use_cls_token:
            ng = cfg.native_grid or g
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
            self.pos_embed = nn.Parameter(torch.zeros(1, ng * ng + 1, cfg.embed_dim))
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.embed_dim))
        self.blocks = nn.ModuleList()
        for i in range(cfg.depth):
            if cfg.use_cls_token:  # global attention over the cls + grid tokens
                self.blocks.append(_global_block(cfg, g * g + 1))
                continue
            global_block = cfg.window_size == 0 or i in cfg.global_attn_indexes
            self.blocks.append(Block(
                cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio,
                0 if global_block else cfg.window_size, cfg.use_rel_pos, cfg.mlp_naming,
                (g, g), cfg.mlp_type, cfg.layer_scale))
        if cfg.use_cls_token:
            self.norm = LayerNorm(cfg.embed_dim)

    def forward(self, x: torch.Tensor):
        cfg = self.config
        b, h, w, _ = x.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        grid = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # (B, gh, gw, C)
        if cfg.use_cls_token:
            # float32 cls + (autocast) patch tokens promote to float32, as in flax
            tokens = grid.reshape(b, gh * gw, cfg.embed_dim).float()
            tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1)
            pos = self.pos_embed
            if cfg.native_grid:
                pos_grid = resample_pos_grid(pos[:, 1:], cfg.native_grid, gh, gw)
                pos = torch.cat([pos[:, :1], pos_grid], 1)
            tokens = (tokens + pos)[:, None]  # (B, 1, n, C): one row of tokens
        else:
            grid = grid + self.pos_embed

        skips = []
        for i, blk in enumerate(self.blocks):
            if cfg.use_cls_token:
                tokens = blk(tokens)
                grid = tokens[:, 0, 1:].reshape(b, gh, gw, cfg.embed_dim)
            else:
                grid = blk(grid)
            if (i + 1) in cfg.extract_layers:
                skips.append(grid)

        if cfg.use_cls_token:
            pooled = self.norm(tokens[:, 0, 0])
        else:
            pooled = grid.mean(dim=(1, 2))
        return grid, skips, pooled


class FoundationViT(nn.Module):
    """Pooled-embedding ViT of the foundation encoders (H-Optimus-0 layout).

    The timm vit_*_reg4_dinov2 graph: patch embed -> pos_embed added to the
    patch tokens only (``no_embed_class``; else to all) -> [cls, reg x N,
    patches] -> global blocks -> final LayerNorm -> the cls token.
    ``forward`` takes (B, H, W, 3) normalised images and returns (B, C)
    float32. ``dtype`` is the compute dtype: under bfloat16 every token,
    the residual stream too, is bfloat16, as in the flax model.
    ``img_size`` fixes pos_embed only where the config has no native grid.
    """

    def __init__(self, config: ViTConfig, img_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        ng = cfg.native_grid or img_size // cfg.patch_size
        self.n_prefix = 0 if cfg.no_embed_class else 1
        c = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, c)
        self.pos_embed = nn.Parameter(torch.zeros(1, ng * ng + self.n_prefix, c))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        if cfg.reg_tokens:
            self.reg_token = nn.Parameter(torch.zeros(1, cfg.reg_tokens, c))
        n_tokens = 1 + cfg.reg_tokens + (img_size // cfg.patch_size) ** 2
        self.blocks = nn.ModuleList(_global_block(cfg, n_tokens) for _ in range(cfg.depth))
        self.norm = LayerNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        p, c = cfg.patch_size, cfg.embed_dim
        b, h, w, _ = x.shape
        gh, gw = h // p, w // p
        ng = round((self.pos_embed.shape[1] - self.n_prefix) ** 0.5)
        with compute_in(self.dtype, x):
            tokens = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            tokens = tokens.reshape(b, gh * gw, c)
            dt = tokens.dtype
            pos_grid = resample_pos_grid(self.pos_embed[:, self.n_prefix:], ng, gh, gw)
            prefix = [self.cls_token.to(dt).expand(b, -1, -1)]
            if cfg.reg_tokens:
                prefix.append(self.reg_token.to(dt).expand(b, -1, -1))
            if cfg.no_embed_class:
                tokens = torch.cat([*prefix, tokens + pos_grid.to(dt)], 1)
            else:
                pos = torch.cat([self.pos_embed[:, :self.n_prefix], pos_grid], 1)
                tokens = torch.cat([*prefix, tokens], 1) + pos.to(dt)
            tokens = tokens[:, None]  # (B, 1, n, C): one row of tokens
            for blk in self.blocks:
                tokens = blk(tokens)
            return self.norm(tokens[:, 0, 0]).float()
