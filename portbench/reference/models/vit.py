"""The EVA-02 ViT backbone in its ViTDet detection form, written plainly
(EVA-02, Fang et al., arXiv:2303.11331; baaivision/EVA, ``EVA-02/det``):
the benchmark's own reference for this backbone, independent of the
program's.

Each block is ``x + attn(norm1(x))`` then ``x + mlp(norm2(x))``, LayerNorm
eps 1e-6, no layer scale, no drop path (inference). Attention: ``qkv``
without bias plus ``q_bias`` and ``v_bias`` (k has none), EVA-02's 2D
rotary embedding on q and k (``rotate_half`` of interleaved pairs, computed
in float32 and cast back as EVA-02's ``VisionRotaryEmbeddingFast`` does),
explicit ``softmax(q k^T / sqrt(d)) v``, ``inner_attn_ln``, ``proj``. MLP:
SwiGLU with ``ffn_ln``. Windowed blocks pad the normalized map with zeros at
the bottom and right, partition it into windows, attend inside each with
no mask and crop the padding away after ``proj`` (ViTDet's
``window_partition`` / ``window_unpartition``); global blocks attend over a
camera's whole grid. The absolute position table drops its cls entry and is
resized bicubically (``align_corners=False``) to the grid at every call.
Linear layers, the patch conv and the LayerNorms are ``layers.py``'s, so
the control's ``one_step_lower`` reaches them.

Departures from the published description, each stated by the benchmark's
configuration (``configs/streampetr_vitl_nusc.json``, ``assumed``):

- a global block's rotary positions on the rectangular grid: position p of
  an axis of length S sits at ``p * rope_grid / S`` on each axis (EVA-02's
  detection code builds one square table for the configured image size);
- ``qkv`` is one projection (EVA-02 keeps ``q_proj``, ``k_proj``,
  ``v_proj``; the same map);
- attention is computed a group of rows at a time (a camera at a time in a
  global block) so that the float32 scores fit the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """EVA-02-L as ViTDet runs it (the defaults)."""
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_hidden_dim: int = 2730          # int(1024 * 4 * 2 / 3), SwiGLU
    window_size: int = 16
    global_blocks: Tuple[int, ...] = (2, 5, 8, 11, 14, 17, 20, 23)
    pos_grid: int = 14                  # the 224-pixel pretraining grid
    rope_grid: int = 16                 # rotary positions scaled into it
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6


def rope_tables(rows: int, cols: int, head_dim: int, grid: int,
                theta: float, device):
    """EVA-02's ``VisionRotaryEmbeddingFast`` on a rows x cols grid: (cos,
    sin), each (rows * cols, head_dim), float32."""
    dim = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device)
                             [:dim // 2].float() / dim))

    def axis(n):
        t = torch.arange(n, device=device).float() / n * grid
        return torch.einsum('i,f->if', t, freqs).repeat_interleave(2, -1)

    fr = torch.cat([axis(rows)[:, None, :].expand(rows, cols, dim),
                    axis(cols)[None, :, :].expand(rows, cols, dim)], dim=-1)
    return fr.cos().reshape(-1, head_dim), fr.sin().reshape(-1, head_dim)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x.unbind(dim=-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * windows, ws, ws, C) after zero padding, and the
    padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg.embed_dim
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.qkv = Linear(c, 3 * c, bias=False)
        self.q_bias = nn.Parameter(torch.empty(c))
        self.v_bias = nn.Parameter(torch.empty(c))
        self.inner_attn_ln = LayerNorm(c, eps=cfg.norm_eps)
        self.proj = Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh = self.num_heads
        d = c // nh
        n = h * w
        bias = torch.cat((self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias)).to(x.dtype)
        qkv = self.qkv(x.reshape(b, n, c)) + bias
        q, k, v = qkv.reshape(b, n, 3, nh, d).permute(2, 0, 3, 1, 4)
        cos, sin = rope_tables(h, w, d, self.cfg.rope_grid,
                               self.cfg.rope_theta, x.device)
        q = (q * cos + rotate_half(q) * sin).type_as(v)
        k = (k * cos + rotate_half(k) * sin).type_as(v)
        rows = max(1, (1 << 28) // (nh * n * n))
        out = []
        for i in range(0, b, rows):
            s = q[i:i + rows] @ k[i:i + rows].transpose(-2, -1) / math.sqrt(d)
            out.append(s.softmax(dim=-1) @ v[i:i + rows])
        x = torch.cat(out).transpose(1, 2).reshape(b, n, c)
        x = self.proj(self.inner_attn_ln(x))
        return x.view(b, h, w, c)


class SwiGLU(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c, hid = cfg.embed_dim, cfg.mlp_hidden_dim
        self.w1 = Linear(c, hid)
        self.w2 = Linear(c, hid)
        self.ffn_ln = LayerNorm(hid, eps=cfg.norm_eps)
        self.w3 = Linear(hid, c)

    def forward(self, x):
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, window_size: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.mlp = SwiGLU(cfg)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = Conv2d(3, cfg.embed_dim, cfg.patch_size,
                           stride=cfg.patch_size)


def get_abs_pos(abs_pos: torch.Tensor, hw) -> torch.Tensor:
    """ViTDet's ``get_abs_pos`` with a cls entry: (1, h, w, C)."""
    h, w = hw
    abs_pos = abs_pos[:, 1:]
    size = int(math.sqrt(abs_pos.shape[1]))
    pos = F.interpolate(abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
                        size=(h, w), mode='bicubic', align_corners=False)
    return pos.permute(0, 2, 3, 1)


class ViT(nn.Module):
    """(B, 3, H, W) images -> (B, embed_dim, H / patch, W / patch)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.pos_grid ** 2 + 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            [Block(cfg, 0 if i in cfg.global_blocks else cfg.window_size)
             for i in range(cfg.depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        x = x + get_abs_pos(self.pos_embed.float(),
                            (x.shape[1], x.shape[2])).to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)
