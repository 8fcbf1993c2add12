"""Detr3D temporal decoder with perspective-aware aggregation (counterpart of
``far3d_tpu/models/decoder.py``; reference detr3d_transformer.py).

Op order per layer: self_attn -> norm -> cross_attn -> norm -> ffn -> norm,
with the temporal memory concatenated into the self-attention keys and values
(:377-396). The cross attention's sampling is ``ops.msda``: the plain version
on the CPU, the hand-written CUDA kernel on the card. Dropout is the identity
at inference and is not modelled.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DecoderConfig, DeformableAggConfig
from ..geometry import denormalize_from_pc_range, project_to_image
from ..ops.msda import MSDA
from .layers import FFN, Linear


class DeformableAggregation(nn.Module):
    """Multi-camera multi-scale deformable cross-attention
    (detr3d_transformer.py:483-569).

    Per query: `num_pts` key points = the reference point plus learned
    offsets; weights = softmax over (cams x levels x points) per group, with a
    camera embedding of lidar2img[:3, :4] added to the query; bilinear samples
    from every camera's pyramid, summed over cameras."""

    def __init__(self, cfg: DeformableAggConfig,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 pad_hw: Tuple[int, int], pc_range: Sequence[float]):
        super().__init__()
        self.cfg = cfg
        self.pad_hw = pad_hw
        self.pc_range = tuple(pc_range)
        ch = cfg.embed_dims
        self.learnable_fc = Linear(ch, cfg.num_pts * 3)
        self.cam_embed = nn.Sequential(
            Linear(12, ch // 2), nn.ReLU(), Linear(ch // 2, ch), nn.ReLU(),
            nn.LayerNorm(ch, eps=1e-5))
        self.weights_fc = Linear(
            ch, cfg.num_groups * cfg.num_levels * cfg.num_pts)
        self.output_proj = Linear(ch, ch)
        self.sampler = MSDA(spatial_shapes)

    def forward(self, instance_feature: torch.Tensor,   # (B, Q, C)
                query_pos: torch.Tensor,                # (B, Q, C)
                feat_flatten: torch.Tensor,             # (B*N, L_total, C)
                reference_points: torch.Tensor,         # (B, Q, 3) in [0, 1]
                lidar2img: torch.Tensor) -> torch.Tensor:  # (B, N, 4, 4)
        c = self.cfg
        b, q, ch = instance_feature.shape
        n, g, nl, p = c.num_cams, c.num_groups, c.num_levels, c.num_pts
        ref_global = denormalize_from_pc_range(reference_points, self.pc_range)
        offsets = self.learnable_fc(instance_feature)
        key_points = ref_global[:, :, None, :] + offsets.reshape(b, q, p, 3)

        # camera-modulated weights (:535-542); weights_fc's outputs are
        # ordered (level, point, group), the softmax runs jointly over
        # cams x levels x points for each group (decoder.py:84-91)
        l2i_flat = lidar2img[..., :3, :].reshape(b, n, 12).to(
            instance_feature.dtype)
        ce = self.cam_embed(l2i_flat)                            # (B, N, C)
        feat_pos = (instance_feature + query_pos)[:, :, None, :] + ce[:, None]
        w = self.weights_fc(feat_pos).reshape(b, q, n * nl * p, g)
        w = w.softmax(dim=-2).reshape(b, q, n, nl, p, g)
        w = w.permute(0, 2, 1, 5, 3, 4).reshape(b * n, q, g, nl, p).contiguous()

        # project the key points into every camera (:547-552)
        uv, _ = project_to_image(key_points[:, None],
                                 lidar2img[:, :, None, None])
        pad_h, pad_w = self.pad_hw
        loc = uv / torch.tensor([pad_w, pad_h], dtype=uv.dtype,
                                device=uv.device)
        loc = loc.reshape(b * n, q, p, 2)

        feats = self.sampler(feat_flatten, loc, w)               # (B*N, Q, C)
        feats = feats.reshape(b, n, q, ch).sum(dim=1)
        return self.output_proj(feats) + instance_feature


class SelfAttention(nn.Module):
    """Multi-head attention with additive positional embeddings; the keys and
    values include the temporal memory (detr3d_transformer.py:377-396).
    ``attn`` holds the reference's packed ``in_proj`` and ``out_proj``."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.attn = nn.MultiheadAttention(embed_dims, num_heads,
                                          batch_first=True)

    def forward(self, query, query_pos, key, key_pos,
                attn_mask: Optional[torch.Tensor] = None):
        """attn_mask: (B, Q, K) or (Q, K) bool, True = blocked."""
        b, nq, c = query.shape
        nk = key.shape[1]
        hd = c // self.num_heads
        wq, wk, wv = self.attn.in_proj_weight.chunk(3)
        bq, bk, bv = self.attn.in_proj_bias.chunk(3)

        def heads(x, w, bias, n):
            return F.linear(x, w, bias).reshape(b, n, self.num_heads, hd
                                                ).transpose(1, 2)

        qh = heads(query + query_pos, wq, bq, nq)
        kh = heads(key + key_pos, wk, bk, nk)
        vh = heads(key, wv, bv, nk)
        allowed = None
        if attn_mask is not None:
            allowed = ~attn_mask
            allowed = allowed[None, None] if allowed.dim() == 2 else \
                allowed[:, None]
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed)
        out = out.transpose(1, 2).reshape(b, nq, c)
        return query + self.attn.out_proj(out)


class DecoderLayer(nn.Module):
    """self_attn -> norm -> cross_attn -> norm -> ffn -> norm
    (detr3d_transformer.py:311-422)."""

    def __init__(self, cfg: DecoderConfig, deform: DeformableAggConfig,
                 spatial_shapes, pad_hw, pc_range):
        super().__init__()
        self.attentions = nn.ModuleList([
            SelfAttention(cfg.embed_dims, cfg.num_heads),
            DeformableAggregation(deform, spatial_shapes, pad_hw, pc_range)])
        self.norms = nn.ModuleList(
            [nn.LayerNorm(cfg.embed_dims, eps=1e-5) for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(cfg.embed_dims, cfg.ffn_dims)])

    def forward(self, query, query_pos, feat_flatten, temp_memory, temp_pos,
                reference_points, lidar2img, attn_mask):
        key = torch.cat([query, temp_memory], dim=1)
        key_pos = torch.cat([query_pos, temp_pos], dim=1)
        query = self.attentions[0](query, query_pos, key, key_pos, attn_mask)
        query = self.norms[0](query)
        query = self.attentions[1](query, query_pos, feat_flatten,
                                   reference_points, lidar2img)
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query))


class Decoder(nn.Module):
    """Stack of decoder layers; returns every layer's output
    (num_layers, B, Q, C) (detr3d_transformer.py:126-190)."""

    def __init__(self, cfg: DecoderConfig, deform: DeformableAggConfig,
                 spatial_shapes, pad_hw, pc_range):
        super().__init__()
        self.layers = nn.ModuleList([
            DecoderLayer(cfg, deform, spatial_shapes, pad_hw, pc_range)
            for _ in range(cfg.num_layers)])

    def forward(self, query, query_pos, feat_flatten, temp_memory, temp_pos,
                reference_points, lidar2img, attn_mask):
        intermediates = []
        for layer in self.layers:
            query = layer(query, query_pos, feat_flatten, temp_memory,
                          temp_pos, reference_points, lidar2img, attn_mask)
            intermediates.append(query)
        return torch.stack(intermediates)
