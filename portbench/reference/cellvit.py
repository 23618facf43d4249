"""CellViT with a SAM encoder (Hörst et al. 2024; Kirillov et al. 2023) as
published, in plain torch on a state dict with the published module names:
the ViT with windowed and global blocks and decomposed relative positions
(SAM's window partition pads the token grid with zeros, so a padded key
takes part in its window's softmax), skips after blocks 8, 16, 24 and 32
for SAM-H, and three U-Net branches (nuclei binary map, HV map, nuclei
types) of 2x2 transposed convolutions and 3x3 conv + batch norm + ReLU
blocks. ``maps`` gives the post-processed maps over each patch's interior:
the nuclei probability, the HV field and the type probabilities."""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from .numerics import cast, exact_float32


class SamCellViT:
    def __init__(self, sd: dict, widths: dict, precision: str = "float32"):
        self.sd, self.w, self.p = sd, widths, precision

    # -- layers ---------------------------------------------------------------
    def linear(self, x, key):
        return F.linear(cast(x, self.p), cast(self.sd[f"{key}.weight"], self.p),
                        self.sd[f"{key}.bias"].float())

    def conv(self, x, key, padding=1):
        bias = self.sd.get(f"{key}.bias")
        return F.conv2d(cast(x, self.p), cast(self.sd[f"{key}.weight"], self.p),
                        None if bias is None else bias.float(), padding=padding)

    def deconv(self, x, key):
        return F.conv_transpose2d(cast(x, self.p), cast(self.sd[f"{key}.weight"], self.p),
                                  self.sd[f"{key}.bias"].float(), stride=2)

    def layer_norm(self, x, key):
        return F.layer_norm(x, (x.shape[-1],), self.sd[f"{key}.weight"], self.sd[f"{key}.bias"],
                            eps=1e-6)

    def conv_block(self, x, key):  # Conv2DBlock
        return torch.relu(self.bn(self.conv(x, f"{key}.conv"), f"{key}.bn"))

    def deconv_block(self, x, key):  # Deconv2DBlock
        return torch.relu(self.bn(self.conv(self.deconv(x, f"{key}.deconv"), f"{key}.conv"),
                                  f"{key}.bn"))

    def bn(self, x, key):
        sd = self.sd
        scale = sd[f"{key}.weight"] * torch.rsqrt(sd[f"{key}.running_var"] + 1e-5)
        shift = sd[f"{key}.bias"] - sd[f"{key}.running_mean"] * scale
        return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)

    # -- encoder ----------------------------------------------------------------
    def attention(self, x, key, window):
        """SAM's Attention over (B, H, W, C), windowed when ``window``."""
        b, h, w, c = x.shape
        heads = self.w["num_heads"]
        hd = c // heads
        if window:
            hp, wp = -(-h // window) * window, -(-w // window) * window
            x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
            x = x.reshape(b, hp // window, window, wp // window, window, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
        bw, ah, aw, _ = x.shape
        qkv = self.linear(x, f"{key}.qkv").reshape(bw, ah * aw, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, bw * heads, ah * aw, hd)
        attn = (cast(q, self.p) * hd ** -0.5) @ cast(k, self.p).transpose(-2, -1)
        rh = self.rel_pos(self.sd[f"{key}.rel_pos_h"], ah)
        rw = self.rel_pos(self.sd[f"{key}.rel_pos_w"], aw)
        rq = cast(q, self.p).reshape(bw * heads, ah, aw, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", rq, cast(rh, self.p))
        rel_w = torch.einsum("bhwc,wkc->bhwk", rq, cast(rw, self.p))
        attn = attn.view(-1, ah, aw, ah, aw) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
        attn = torch.softmax(attn.view(-1, ah * aw, ah * aw), dim=-1)
        out = (cast(attn, self.p) @ cast(v, self.p)).view(bw, heads, ah, aw, hd)
        out = out.permute(0, 2, 3, 1, 4).reshape(bw, ah, aw, c)
        out = self.linear(out, f"{key}.proj")
        if window:
            out = out.reshape(b, hp // window, wp // window, window, window, c)
            out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w]
        return out

    @staticmethod
    def rel_pos(table, size):
        """SAM's get_rel_pos for equal query and key sizes: (size, size, C)."""
        if table.shape[0] != 2 * size - 1:
            raise ValueError(f"rel-pos table of {table.shape[0]} rows for a side of {size}")
        idx = np.arange(size)[:, None] - np.arange(size)[None, :] + size - 1
        return table[torch.from_numpy(idx).to(table.device)]

    def encoder(self, x):
        """(B, H, W, 3) normalized -> the four skips, (B, C, H/16, W/16)."""
        w = self.w
        g = F.conv2d(cast(x.permute(0, 3, 1, 2), self.p),
                     cast(self.sd["encoder.patch_embed.proj.weight"], self.p),
                     self.sd["encoder.patch_embed.proj.bias"].float(), stride=w["patch_size"])
        g = g.permute(0, 2, 3, 1) + self.sd["encoder.pos_embed"]
        skips = []
        for i in range(w["depth"]):
            key = f"encoder.blocks.{i}"
            window = 0 if i in w["global_attn_indexes"] else w["window_size"]
            g = g + self.attention(self.layer_norm(g, f"{key}.norm1"), f"{key}.attn", window)
            h = self.layer_norm(g, f"{key}.norm2")
            h = self.linear(F.gelu(self.linear(h, f"{key}.mlp.lin1")), f"{key}.mlp.lin2")
            g = g + h
            if i + 1 in w["extract_layers"]:
                skips.append(g.permute(0, 3, 1, 2))
        return skips

    # -- decoders -------------------------------------------------------------
    def branch(self, img, z1, z2, z3, z4, key):
        y = torch.cat([self.deconv_block(z3, f"{key}.decoder3.0"),
                       self.deconv(z4, f"{key}.bottleneck_upsampler")], 1)
        for i in range(3):
            y = self.conv_block(y, f"{key}.decoder3_upsampler.{i}")
        y = self.deconv(y, f"{key}.decoder3_upsampler.3")
        s = z2
        for i in range(2):
            s = self.deconv_block(s, f"{key}.decoder2.{i}")
        y = torch.cat([s, y], 1)
        for i in range(2):
            y = self.conv_block(y, f"{key}.decoder2_upsampler.{i}")
        y = self.deconv(y, f"{key}.decoder2_upsampler.2")
        s = z1
        for i in range(3):
            s = self.deconv_block(s, f"{key}.decoder1.{i}")
        y = torch.cat([s, y], 1)
        for i in range(2):
            y = self.conv_block(y, f"{key}.decoder1_upsampler.{i}")
        y = self.deconv(y, f"{key}.decoder1_upsampler.2")
        s = img
        for i in range(2):
            s = self.conv_block(s, f"{key}.decoder0.{i}")
        y = torch.cat([s, y], 1)
        for i in range(2):
            y = self.conv_block(y, f"{key}.decoder0_header.{i}")
        return self.conv(y, f"{key}.decoder0_header.2", padding=0)

    def decoder0_features(self, x):
        """The nuclei branch's image features (B, 64, H, W), before its header."""
        with exact_float32():
            s = x.permute(0, 3, 1, 2)
            for i in range(2):
                s = self.conv_block(s, f"nuclei_binary_map_decoder.decoder0.{i}")
            return s

    def logits(self, x, halo: int):
        """(B, H, W, 3) normalized -> (np, hv, tp) logits over the interior."""
        with exact_float32():
            z1, z2, z3, z4 = self.encoder(x)
            img = x.permute(0, 3, 1, 2)
            out = [self.branch(img, z1, z2, z3, z4, key) for key in (
                "nuclei_binary_map_decoder", "hv_map_decoder", "nuclei_type_maps_decoder")]
        if halo:
            out = [m[:, :, halo:-halo, halo:-halo] for m in out]
        return out


def normalize(patches_u8: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize(0.5, 0.5), kept channel-last."""
    return (patches_u8.float() / 255.0 - 0.5) / 0.5


def maps(model: SamCellViT, patches: np.ndarray, halo: int, device, block: int = 8):
    """(np_prob (N, S, S), hv (N, 2, S, S), tp_prob (N, K, S, S)) as float32
    CPU tensors: the nuclei probability (softmax, channel 1), the HV field,
    the type probabilities (softmax), ``block`` patches at a time."""
    npp, hv, tp = [], [], []
    for i in range(0, len(patches), block):
        x = normalize(torch.from_numpy(patches[i:i + block]).to(device))
        n_l, h_l, t_l = model.logits(x, halo)
        npp.append(torch.softmax(n_l, 1)[:, 1].cpu())
        hv.append(h_l.cpu())
        tp.append(torch.softmax(t_l, 1).cpu())
    return torch.cat(npp), torch.cat(hv), torch.cat(tp)


def fisher_head(feats: torch.Tensor, inside: torch.Tensor) -> tuple[torch.Tensor, float, float]:
    """Fisher's discriminant between two pixel sets of (n, C) features:
    (direction, scale to a spread of 4, threshold at the inside share)."""
    f = feats.double()
    cov = torch.cov(f[inside].T) + torch.cov(f[~inside].T)
    ridge = 1e-3 * cov.diagonal().mean() * torch.eye(len(cov), dtype=f.dtype, device=f.device)
    w = torch.linalg.solve(cov + ridge, f[inside].mean(0) - f[~inside].mean(0))
    proj = f @ w
    scale = 4.0 / float(proj.std())
    share = float(inside.double().mean())
    thr = float(np.quantile(proj.cpu().numpy(), 1 - share))
    return w.float(), scale, thr
