"""The EVA-02 ViT backbone in its ViTDet detection form (EVA-02, Fang et
al., arXiv:2303.11331; baaivision/EVA, ``EVA-02/det``), the image side of
StreamPETR's ViT-L entries (``models/streampetr_vit.py``).

A 16x16 stride-16 patch embedding, an absolute position table learnt on the
pretraining grid and resized bicubically to the image's grid, then
``depth`` blocks of ``x + attn(norm1(x))``, ``x + mlp(norm2(x))``:

- attention: one ``qkv`` projection without bias, separate ``q_bias`` and
  ``v_bias`` (k has none), 2D rotary position embedding on q and k (one
  hand-written kernel on the card, ``vit_rope``), softmax attention, a
  sub-LayerNorm ``inner_attn_ln``, ``proj``;
- a SwiGLU MLP with a sub-LayerNorm: ``w3(ffn_ln(silu(w1 x) * w2 x))``,
  its tail between the two matmuls one hand-written kernel on the card
  (``swiglu_tail``);
- the blocks of ``global_blocks`` attend over the whole grid of a camera;
  the others over ``window_size`` windows of the grid zero-padded at the
  bottom and right, as ViTDet pads: the padded rows are zeros after
  ``norm1``, take part as keys and values with no mask, and their outputs
  are cropped away.

The output is the stride-16 map after the last block, with no final norm.
Parameter names are EVA-02's. Every layer computes in its input's dtype
(``models/layers.py``). The rotary tables are computed values, kept per
grid, device and dtype; the position table is resized from the loaded
weights at the first inference call for a grid and kept until the weights
change.

Labels (``utils/spans.py``): ``model.backbone.patch`` around the patch
embedding and position, ``model.backbone.window`` and
``model.backbone.global`` around each block.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.spans import span
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


_ROPE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_tables(rows: int, cols: int, head_dim: int, grid: int,
                theta: float, device, dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (rows * cols, head_dim), of EVA-02's 2D rotary
    embedding on a rows x cols grid in row-major order: the first half of
    the head's channels turn with the row, the second with the column; in
    each half frequency i < head_dim / 4 is ``theta ** (-4 i / head_dim)``,
    used by one interleaved pair; position p of an axis of length S sits at
    ``p * grid / S``. `sin` carries the sign of the pair's rotation: minus
    on a pair's first channel, plus on its second (see
    ``rope_reference``). Made at the first call for its arguments and
    kept."""
    key = (rows, cols, head_dim, grid, theta, torch.device(device), dtype)
    out = _ROPE.get(key)
    if out is None:
        half = head_dim // 2
        freqs = theta ** (-torch.arange(0, half, 2, dtype=torch.float64)
                          / half)

        def axis(n):
            t = torch.arange(n, dtype=torch.float64) * grid / n
            return (t[:, None] * freqs).repeat_interleave(2, dim=-1)

        ang = torch.cat([axis(rows)[:, None].expand(rows, cols, half),
                         axis(cols)[None].expand(rows, cols, half)], dim=-1)
        ang = ang.reshape(rows * cols, head_dim)
        sign = torch.tensor([-1.0, 1.0], dtype=torch.float64).repeat(half)
        with torch.inference_mode(False):
            out = tuple(t.to(device=device, dtype=dtype)
                        for t in (ang.cos(), ang.sin() * sign))
        _ROPE[key] = out
    return out


def rope_reference(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                   ) -> torch.Tensor:
    """``x * cos + rotate_pairs(x) * sin`` of EVA-02, where
    ``rotate_pairs`` turns each interleaved pair (a, b) of the last dim into
    (-b, a): with the signs in ``rope_tables``'s `sin`, the pair swapped to
    (b, a) times `sin`."""
    swapped = x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.addcmul(x * cos, swapped, sin)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """``rope_reference`` for a tensor on the CPU, the hand-written kernel
    (``ops/rope_cuda.py``) for a CUDA one: q and k, the (2, B, nh, S, d)
    view ``qkv[:2]``, rotated in one pass."""
    if x.is_cuda:
        from ..ops.rope_cuda import rope_cuda
        return rope_cuda(x, cos, sin)
    return rope_reference(x, cos, sin)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (..., tokens, d), no mask."""
    return F.scaled_dot_product_attention(q, k, v)


def window_partition(x: torch.Tensor, ws: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) zero-padded at the bottom and right to multiples of
    `ws` -> (B * windows, ws, ws, C), and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, -w % ws, 0, -h % ws))
    hp, wp = x.shape[1:3]
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, padded: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of ``window_partition``, the padding cropped away."""
    hp, wp = padded
    b = x.shape[0] // (hp // ws * (wp // ws))
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :hw[0], :hw[1]]


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.rope = (cfg.rope_grid, cfg.rope_theta)
        self.qkv = Linear(c, 3 * c, bias=False)
        self.q_bias = nn.Parameter(torch.empty(c))
        self.v_bias = nn.Parameter(torch.empty(c))
        self.inner_attn_ln = LayerNorm(c, eps=cfg.norm_eps)
        self.proj = Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) normalized -> (B, H, W, C), attending over each
        H x W grid."""
        b, h, w, c = x.shape
        nh = self.num_heads
        d = c // nh
        bias = torch.cat((self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias)).to(x.dtype)
        qkv = F.linear(x, self.qkv.weight.to(x.dtype), bias)
        qkv = qkv.view(b, h * w, 3, nh, d).permute(2, 0, 3, 1, 4)
        cos, sin = rope_tables(h, w, d, *self.rope, x.device, x.dtype)
        qk = rope(qkv[:2], cos, sin)
        o = attention(qk[0], qk[1], qkv[2])              # (B, nh, HW, d)
        o = o.transpose(1, 2).reshape(b, h, w, c)
        return self.proj(self.inner_attn_ln(o))


def swiglu_tail_reference(ag: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain SwiGLU tail: ``ffn_ln(silu(a) * g)`` from the ``w12``
    product ag (..., 2 W), whose halves a and g each hold the len(weight)
    real channels padded to W, padded in turn with zeros to (..., W), w3's
    input."""
    hid, width = weight.shape[0], ag.shape[-1] // 2
    a, g = ag[..., :hid], ag[..., width:width + hid]
    h = F.layer_norm(F.silu(a) * g, (hid,), weight, bias, eps)
    return F.pad(h, (0, width - hid))


def swiglu_tail(ag: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``swiglu_tail_reference`` for a tensor on the CPU, the hand-written
    kernel (``ops/swiglu_cuda.py``) for a CUDA one."""
    if ag.is_cuda:
        from ..ops.swiglu_cuda import swiglu_tail_cuda
        return swiglu_tail_cuda(ag, weight, bias, eps)
    return swiglu_tail_reference(ag, weight, bias, eps)


class SwiGLU(nn.Module):
    """``w3(ffn_ln(silu(w1 x) * w2 x))``. The hidden width is padded with
    zero rows of the weights to a multiple of 8 inside the matmuls (2,730
    to 2,736), so that their rows are 16-byte aligned in bf16 (the card's
    fast matmuls need that); ``swiglu_tail`` leaves the padding out of
    ``ffn_ln`` and writes zeros there, which multiply zero columns of
    ``w3``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c, hid = cfg.embed_dim, cfg.mlp_hidden_dim
        self.w1 = Linear(c, hid)
        self.w2 = Linear(c, hid)
        self.ffn_ln = LayerNorm(hid, eps=cfg.norm_eps)
        self.w3 = Linear(hid, c)

    def forward(self, x):
        pad = -self.w1.out_features % 8
        w12 = torch.cat([F.pad(self.w1.weight, (0, 0, 0, pad)),
                         F.pad(self.w2.weight, (0, 0, 0, pad))]).to(x.dtype)
        b12 = torch.cat([F.pad(self.w1.bias, (0, pad)),
                         F.pad(self.w2.bias, (0, pad))]).to(x.dtype)
        h = swiglu_tail(F.linear(x, w12, b12),
                        self.ffn_ln.weight.to(x.dtype),
                        self.ffn_ln.bias.to(x.dtype), self.ffn_ln.eps)
        return F.linear(h, F.pad(self.w3.weight, (0, pad)).to(x.dtype),
                        self.w3.bias.to(x.dtype))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, window: int):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.mlp = SwiGLU(cfg)

    def forward(self, x):
        with span('model.backbone.window' if self.window
                  else 'model.backbone.global'):
            h = self.norm1(x)
            if self.window:
                h, padded = window_partition(h, self.window)
            h = self.attn(h)
            if self.window:
                h = window_unpartition(h, self.window, padded, x.shape[1:3])
            x = x + h
            return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = Conv2d(3, cfg.embed_dim, cfg.patch_size,
                           stride=cfg.patch_size)


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
        self._pos = None

    def abs_pos(self, h: int, w: int, dtype) -> torch.Tensor:
        """The position table without its cls entry, resized bicubically
        (``align_corners=False``) from the pretraining grid to h x w:
        (1, h, w, C). Outside autograd it is made once per grid, dtype and
        loaded table, and kept."""
        table = self.pos_embed
        key = (h, w, dtype, table.device, table.data_ptr(), table._version)
        keep = not torch.is_grad_enabled()
        if keep and self._pos is not None and self._pos[0] == key:
            return self._pos[1]
        g = self.cfg.pos_grid
        grid = table[:, 1:].float().reshape(1, g, g, -1).permute(0, 3, 1, 2)
        pos = F.interpolate(grid, size=(h, w), mode='bicubic',
                            align_corners=False).permute(0, 2, 3, 1).to(dtype)
        if keep:
            self._pos = (key, pos)
        return pos

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span('model.backbone.patch'):
            x = self.patch_embed.proj(x).permute(0, 2, 3, 1)   # (B, h, w, C)
            x = x + self.abs_pos(x.shape[1], x.shape[2], x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)
