"""The PETR / StreamPETR dense-attention stack (counterpart of
``far3d_tpu/models/petr.py``; reference models/utils/petr_transformer.py and
the frustum position encoder of models/utils/positional_encoding.py:82-200).

Every module computes in the dtype of its input, as the flax modules do with
``dtype=x.dtype``: bf16 tokens keep the decoder in bf16. Parameter names are
the flax tree's, so ``utils/convert.py:petr_from_jax_variables`` carries the
JAX package's weights across by name.

Two attentions, as in the JAX package:

* ``MultiHeadAttention`` is flax's ``MultiHeadDotProductAttention`` (the
  decoder's self-attention): ``query`` / ``key`` / ``value`` / ``out``
  projections, the query scaled by 1/sqrt(d) before the product, a boolean
  mask filled with the dtype's lowest value, and the softmax in the input's
  dtype.
* ``FlashMHA`` (the dense cross-attention over every image token) scales
  the scores by 1/sqrt(d) and takes the softmax in f32. XLA computes it in
  the JAX package, no Pallas kernel; here it is one
  ``F.scaled_dot_product_attention`` call on both devices (f32 softmax
  inside the fused kernels on the card, f32 math on the CPU). ``key_valid``
  becomes an additive mask of -1e9, so a query whose keys are all invalid
  attends to them uniformly, as ``where(key_valid, s, -1e9)`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.constants import constant
from ..utils.spans import span
from .layers import FFN, LayerNorm, Linear, dropout


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with qkv_features = out_features
    = embed_dims and no attention dropout (its default rate 0)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(embed_dims, embed_dims)
        self.key = Linear(embed_dims, embed_dims)
        self.value = Linear(embed_dims, embed_dims)
        self.out = Linear(embed_dims, embed_dims)

    def forward(self, inputs_q, inputs_k, inputs_v,
                mask: Optional[torch.Tensor] = None):
        """mask broadcasts to (B, heads, Q, K), True = attend."""
        b, nq, c = inputs_q.shape
        h = self.num_heads
        d = c // h

        def heads(x):
            return x.reshape(b, x.shape[1], h, d).transpose(1, 2)

        scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(
            inputs_q.dtype)
        q = heads(self.query(inputs_q)) / scale
        k, v = heads(self.key(inputs_k)), heads(self.value(inputs_v))
        s = q @ k.transpose(-1, -2)
        if mask is not None:
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        p = torch.softmax(s, dim=-1)
        out = (p @ v).transpose(1, 2).reshape(b, nq, c)
        return self.out(out)


class FlashMHA(nn.Module):
    """Dense exact attention (reference FlashMHA, attention.py:94-137):
    q/k/v projections (C -> heads x d), softmax(q k^T / sqrt(d)) v in f32,
    the output projection. ``key_valid`` (B, K), True = attend."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dims, embed_dims)
        self.k_proj = Linear(embed_dims, embed_dims)
        self.v_proj = Linear(embed_dims, embed_dims)
        self.out_proj = Linear(embed_dims, embed_dims)

    def forward(self, q, k, v, key_valid: Optional[torch.Tensor] = None):
        b, nq, c = q.shape
        h = self.num_heads

        def heads(x):
            return x.reshape(b, x.shape[1], h, c // h).transpose(1, 2)

        mask = None
        if key_valid is not None:
            mask = torch.zeros(key_valid.shape, dtype=q.dtype,
                               device=q.device).masked_fill(~key_valid, -1e9)
            mask = mask[:, None, None, :]
        out = F.scaled_dot_product_attention(
            heads(self.q_proj(q)), heads(self.k_proj(k)),
            heads(self.v_proj(v)), attn_mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, c))


class PETRTemporalDecoderLayer(nn.Module):
    """self_attn (queries + propagated memory) -> norm -> dense cross_attn
    over all image tokens -> norm -> ffn -> norm (petr_transformer.py:
    501-741). In training, dropouts follow both attentions and the FFN's
    linears, drawn from `generator`."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 ffn_dims: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(embed_dims, num_heads)
        self.norm0 = LayerNorm(embed_dims, eps=1e-5)
        self.cross_attn = FlashMHA(embed_dims, num_heads)
        self.norm1 = LayerNorm(embed_dims, eps=1e-5)
        self.ffn = FFN(embed_dims, ffn_dims, dropout)
        self.norm2 = LayerNorm(embed_dims, eps=1e-5)

    def forward(self, query, query_pos, feats, feats_pos, temp_memory=None,
                temp_pos=None, attn_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None, key_valid=None):
        if temp_memory is not None:
            k = torch.cat([query, temp_memory], dim=1)
            kp = torch.cat([query_pos, temp_pos], dim=1)
        else:
            k, kp = query, query_pos
        mask = None
        if attn_mask is not None:          # True = blocked, as the reference
            m = ~attn_mask
            mask = m[None, None] if m.dim() == 2 else m[:, None]
        sa = self.self_attn(query + query_pos, k + kp, k, mask)
        query = self.norm0(query + dropout(sa, self.dropout, train, generator))
        ca = self.cross_attn(query + query_pos, feats + feats_pos, feats,
                             key_valid)
        query = self.norm1(query + dropout(ca, self.dropout, train, generator))
        return self.norm2(self.ffn(query, train, generator))


class PETRTemporalTransformer(nn.Module):
    """Decoder stack returning every layer's output, stacked (L, B, Q, C)
    (petr_transformer.py:411-498); layers ``layer0`` ..."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 6,
                 num_heads: int = 8, ffn_dims: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'layer{i}', PETRTemporalDecoderLayer(
                embed_dims, num_heads, ffn_dims, dropout))

    def forward(self, query, query_pos, feats, feats_pos, temp_memory=None,
                temp_pos=None, attn_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        outs = []
        for i in range(self.num_layers):
            with span('model.decoder.layer'):
                query = getattr(self, f'layer{i}')(
                    query, query_pos, feats, feats_pos, temp_memory,
                    temp_pos, attn_mask, train, generator)
            outs.append(query)
        return torch.stack(outs)


class PETREncoderLayer(nn.Module):
    """DETR encoder layer over image tokens: self_attn -> norm -> ffn ->
    norm (petr_transformer.py:331-357)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 ffn_dims: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = FlashMHA(embed_dims, num_heads)
        self.norm0 = LayerNorm(embed_dims, eps=1e-5)
        self.ffn = FFN(embed_dims, ffn_dims, dropout)
        self.norm1 = LayerNorm(embed_dims, eps=1e-5)

    def forward(self, x, pos, key_valid=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        sa = self.self_attn(x + pos, x + pos, x, key_valid)
        x = self.norm0(x + dropout(sa, self.dropout, train, generator))
        return self.norm1(self.ffn(x, train, generator))


class PETRTransformer(nn.Module):
    """Non-temporal DETR-style PETR transformer (petr_transformer.py:789-868
    + :361-409, return_intermediate): an optional token encoder (``enc{i}``),
    zero targets, every decoder layer's output through one shared
    ``post_norm``. Tokens come flattened (B, T, C) with their position
    embedding; ``key_valid`` (B, T) marks the valid ones."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 6,
                 num_encoder_layers: int = 0, num_heads: int = 8,
                 ffn_dims: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.num_encoder_layers = num_encoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f'enc{i}', PETREncoderLayer(
                embed_dims, num_heads, ffn_dims, dropout))
        self.post_norm = LayerNorm(embed_dims, eps=1e-5)
        for i in range(num_layers):
            self.add_module(f'layer{i}', PETRTemporalDecoderLayer(
                embed_dims, num_heads, ffn_dims, dropout))

    def forward(self, feats, feats_pos, query_embed, key_valid=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """query_embed (Q, C). Returns (num_layers, B, Q, C)."""
        for i in range(self.num_encoder_layers):
            feats = getattr(self, f'enc{i}')(feats, feats_pos, key_valid,
                                             train, generator)
        query_pos = query_embed[None].expand(feats.shape[0],
                                             *query_embed.shape)
        query = torch.zeros_like(query_pos)
        outs = []
        for i in range(self.num_layers):
            query = getattr(self, f'layer{i}')(
                query, query_pos, feats, feats_pos, None, None, None, train,
                generator, key_valid=key_valid)
            outs.append(self.post_norm(query))
        return torch.stack(outs)


class FlattenMHSelfAttention(nn.Module):
    """Per-token self-attention of petr_transformer.py:987-1041: each token
    attends only to itself, so the module is ``x + dropout(W_o W_v x)``."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.v_proj = Linear(embed_dims, embed_dims)
        self.out_proj = Linear(embed_dims, embed_dims)

    def forward(self, x, pos=None, identity=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if identity is None:
            identity = x
        out = self.out_proj(self.v_proj(x))
        return identity + dropout(out, self.dropout, train, generator)


class FrustumPE(nn.Module):
    """3D frustum position embedding (positional_encoding.py:82-200): each
    token's ray sampled at LID depths, taken to the ego frame through
    img2lidar, normalized by the position range, then an MLP."""

    def __init__(self, embed_dims: int = 256, depth_num: int = 64,
                 depth_start: float = 1.0,
                 position_range: Tuple[float, ...] = (
                     -152.4, -152.4, -5., 152.4, 152.4, 5.)):
        super().__init__()
        self.depth_num = depth_num
        self.depth_start = depth_start
        self.position_range = position_range
        self.pe_fc1 = Linear(depth_num * 3, embed_dims * 4)
        self.pe_fc2 = Linear(embed_dims * 4, embed_dims)

    def forward(self, feat_hw: Tuple[int, int], pad_hw: Tuple[int, int],
                img2lidar: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """img2lidar (B, N, 4, 4) -> (B*N, H*W, C) in `dtype`."""
        h, w = feat_hw
        pad_h, pad_w = pad_hw
        b, n = img2lidar.shape[:2]
        dev = img2lidar.device
        f32 = dict(dtype=torch.float32, device=dev)
        us = (torch.arange(w, **f32) + 0.5) * (pad_w / w)
        vs = (torch.arange(h, **f32) + 0.5) * (pad_h / h)
        v, u = torch.meshgrid(vs, us, indexing='ij')
        idx = torch.arange(self.depth_num, **f32)
        pr = self.position_range
        bin_size = 2 * (pr[3] - self.depth_start) / (
            self.depth_num * (1 + self.depth_num))
        d = self.depth_start + bin_size * idx * (idx + 1) / 2
        shape = (h, w, self.depth_num)
        uvd = torch.stack([u[..., None] * d, v[..., None] * d,
                           d.expand(shape), torch.ones(shape, **f32)], dim=-1)
        pts = torch.einsum('bnij,hwdj->bnhwdi', img2lidar.float(),
                           uvd)[..., :3]
        lo = constant(pr[:3], torch.float32, dev)
        hi = constant(pr[3:6], torch.float32, dev)
        pts = ((pts - lo) / (hi - lo)).reshape(b * n, h * w,
                                               self.depth_num * 3).to(dtype)
        return self.pe_fc2(F.relu(self.pe_fc1(pts)))


def sine_positional_encoding_2d(h: int, w: int, num_feats: int = 128,
                                temperature: float = 10000.0,
                                normalize: bool = True,
                                device=None) -> torch.Tensor:
    """SinePositionalEncoding3D's per-image 2D part (positional_encoding.py:
    216-308): (H, W, 2 * num_feats), y features first."""
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    y = ones.cumsum(0)
    x = ones.cumsum(1)
    if normalize:
        eps, scale = 1e-6, 2 * math.pi
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
    dim_t = temperature ** (2 * (torch.arange(num_feats, device=device) // 2)
                            / num_feats)

    def embed(t):
        p = t[..., None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).reshape(h, w, num_feats)

    return torch.cat([embed(y), embed(x)], dim=-1)
