"""StreamPETR, the second model family (counterpart of
``far3d_tpu/models/streampetr.py``; reference petr_transformer.py:330-741
and positional_encoding.py:82-200).

Backbone -> FPN -> one FPN level flattened over every camera as the dense
keys and values, with the frustum 3D position embedding -> the temporal
memory queue (the same explicit ``TemporalState`` carry as FarHead) -> the
PETR temporal decoder -> weight-shared cls / reg branches -> the NMS-free
decode of ``models/detector.py:decode_boxes``.

The backbone and neck are the port's ``VoVNet`` and ``FPN`` under Far3D's
names (``img_backbone``, ``img_neck``), so the optimizer's backbone
multiplier and ``ops/quant.py`` apply unchanged; the head is
``pts_bbox_head`` with the flax tree's names below it. As in the JAX
package, the head casts its query side to the tokens' dtype: with bf16
images the decoder runs in bf16, the branches and the memory in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import IMG_MEAN, IMG_STD, BackboneConfig, NeckConfig
from ..geometry import (denormalize_from_pc_range, inverse_sigmoid,
                        nerf_positional_encoding, normalize_to_pc_range,
                        pos2posemb1d, pos2posemb3d)
from ..utils.constants import constant
from ..utils.spans import span
from .farhead import (TemporalState, post_update_memory_fn,
                      pre_update_memory_fn)
from .layers import MLN, MLP, Conv2d, LayerNorm, Linear
from .petr import FrustumPE, PETRTemporalTransformer
from .vovnet import FPN, VoVNet


@dataclasses.dataclass(frozen=True)
class StreamPETRConfig:
    """Knob set of a StreamPETR model (nuScenes defaults), the JAX
    package's field for field."""
    num_classes: int = 10
    embed_dims: int = 256
    num_query: int = 644
    memory_len: int = 512
    topk_proposals: int = 128
    num_propagated: int = 128
    num_layers: int = 6
    num_heads: int = 8
    ffn_dims: int = 2048
    dropout: float = 0.1
    with_ego_pos: bool = True
    code_size: int = 10              # nuScenes code with velocity
    feat_level: int = 1              # FPN level of the dense keys (stride 16)
    depth_num: int = 64              # frustum PE depth bins
    position_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    # decode gate (NMSFreeCoder post_center_range, nuScenes default)
    post_center_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    max_decode_num: int = 300
    # set-prediction loss (StreamPETR nuScenes recipe: focal cls 2.0,
    # weighted L1 0.25, the velocity terms at 0.2)
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 0.25
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    code_weights: Tuple[float, ...] = (2.0, 2.0, 2.0, 1.0, 1.0, 1.0,
                                       1.0, 1.0, 0.2, 0.2)
    backbone: BackboneConfig = BackboneConfig()
    neck: NeckConfig = NeckConfig()
    input_hw: Tuple[int, int] = (320, 800)
    num_cams: int = 6


class StreamPETRHead(nn.Module):
    """The dense-attention streaming head."""

    def __init__(self, cfg: StreamPETRConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.embed_dims
        self.input_proj = Conv2d(ch, ch, 1)
        self.pe = FrustumPE(ch, cfg.depth_num,
                            position_range=cfg.position_range)
        self.reference_points = nn.Parameter(torch.empty(cfg.num_query, 3))
        self.pseudo_reference_points = nn.Parameter(
            torch.empty(cfg.num_propagated, 3))
        self.query_embedding = MLP((ch, ch), in_dim=3 * 128)
        if cfg.with_ego_pos:
            self.ego_pose_pe = MLN(180, ch)
            self.ego_pose_memory = MLN(180, ch)
        self.time_fc = Linear(256, ch)
        self.time_ln = LayerNorm(ch, eps=1e-5)
        self.decoder = PETRTemporalTransformer(
            ch, cfg.num_layers, cfg.num_heads, cfg.ffn_dims, cfg.dropout)
        self.cls_fc0 = Linear(ch, ch)
        self.cls_ln0 = LayerNorm(ch, eps=1e-5)
        self.cls_fc1 = Linear(ch, ch)
        self.cls_ln1 = LayerNorm(ch, eps=1e-5)
        self.cls_out = Linear(ch, cfg.num_classes)
        self.reg_fc0 = Linear(ch, ch)
        self.reg_fc1 = Linear(ch, ch)
        self.reg_out = Linear(ch, cfg.code_size)

    def time_embedding(self, x):
        return self.time_ln(self.time_fc(x))

    def cls_branch(self, x):
        x = F.relu(self.cls_ln0(self.cls_fc0(x)))
        x = F.relu(self.cls_ln1(self.cls_fc1(x)))
        return self.cls_out(x)

    def reg_branch(self, x):
        x = F.relu(self.reg_fc0(x))
        return self.reg_out(F.relu(self.reg_fc1(x)))

    def forward(self,
                feats: torch.Tensor,          # (B*N, C, H, W) one FPN level
                lidar2img: torch.Tensor,      # (B, N, 4, 4)
                state: TemporalState,
                prev_exists: torch.Tensor,    # (B,)
                timestamp: torch.Tensor,      # (B,)
                ego_pose: torch.Tensor,       # (B, 4, 4)
                ego_pose_inv: torch.Tensor,   # (B, 4, 4)
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        c = self.cfg
        b, n = lidar2img.shape[:2]
        h, w = feats.shape[-2:]
        ch = c.embed_dims

        with span('model.queries'):
            feats = self.input_proj(feats)
            tokens = feats.permute(0, 2, 3, 1).reshape(b, n * h * w, ch)
            dt = tokens.dtype

            # frustum 3D position embedding of every token, through img2lidar
            img2lidar = torch.linalg.inv_ex(lidar2img.float())[0]  # no sync
            tokens_pos = self.pe((h, w), c.input_hw, img2lidar, dtype=dt
                                 ).reshape(b, n * h * w, ch)

            state = pre_update_memory_fn(state, prev_exists, timestamp,
                                         ego_pose_inv,
                                         self.pseudo_reference_points,
                                         c.num_propagated, c.pc_range)

            reference_points = self.reference_points[None].expand(
                b, c.num_query, 3)
            query_pos = self.query_embedding(
                pos2posemb3d(reference_points)).to(dt)
            tgt = torch.zeros_like(query_pos)

            # temporal alignment (the ego-motion MLNs of FarHead)
            temp_ref_norm = normalize_to_pc_range(state.ref_points, c.pc_range)
            temp_pos = self.query_embedding(pos2posemb3d(temp_ref_norm)).to(dt)
            temp_memory = state.embedding.to(dt)
            if c.with_ego_pos:
                eye = torch.eye(4, device=tokens.device)[:3].reshape(1, 1, 12)
                rec_motion = torch.cat(
                    [torch.zeros_like(reference_points),
                     eye.expand(b, c.num_query, 12)], dim=-1)
                rec_motion = nerf_positional_encoding(rec_motion.to(dt))
                tgt = self.ego_pose_memory(tgt, rec_motion)
                query_pos = self.ego_pose_pe(query_pos, rec_motion)
                mem_motion = torch.cat(
                    [state.velo, state.timestamp,
                     state.egopose[..., :3, :].reshape(b, c.memory_len, 12)],
                    dim=-1)
                mem_motion = nerf_positional_encoding(mem_motion.to(dt))
                temp_pos = self.ego_pose_pe(temp_pos, mem_motion)
                temp_memory = self.ego_pose_memory(temp_memory, mem_motion)

            query_pos = query_pos + self.time_embedding(
                pos2posemb1d(torch.zeros_like(reference_points[..., :1]))
            ).to(dt)
            temp_pos = temp_pos + self.time_embedding(
                pos2posemb1d(state.timestamp)).to(dt)

            reference_full = reference_points
            np_ = c.num_propagated
            if np_ > 0:
                tgt = torch.cat([tgt, temp_memory[:, :np_]], dim=1)
                query_pos = torch.cat([query_pos, temp_pos[:, :np_]], dim=1)
                reference_full = torch.cat(
                    [reference_points, temp_ref_norm[:, :np_]], dim=1)
                temp_memory = temp_memory[:, np_:]
                temp_pos = temp_pos[:, np_:]

        with span('model.decoder'):
            outs_dec = self.decoder(tgt, query_pos, tokens, tokens_pos,
                                    temp_memory, temp_pos, None, train,
                                    generator)
            outs_dec = torch.nan_to_num(outs_dec.float())

        with span('model.branches'):
            all_cls = self.cls_branch(outs_dec)
            tmp = self.reg_branch(outs_dec)
            ref_logit = inverse_sigmoid(reference_full.float())
            xyz = torch.sigmoid(tmp[..., :3] + ref_logit[None])
            xyz = denormalize_from_pc_range(xyz, c.pc_range)
            all_bbox = torch.cat([xyz, tmp[..., 3:]], dim=-1)

        with span('model.memory'):
            query_valid = torch.ones(all_cls.shape[1:3], dtype=torch.bool,
                                     device=all_cls.device)
            new_state = post_update_memory_fn(
                state, all_cls[-1], all_bbox[-1], outs_dec[-1], query_valid,
                timestamp, ego_pose, c.topk_proposals, c.memory_len)
        return {'all_cls_scores': all_cls, 'all_bbox_preds': all_bbox,
                'query_valid': query_valid, 'state': new_state}


class StreamPETR(nn.Module):
    """Backbone -> FPN -> one-level dense tokens -> StreamPETRHead."""

    def __init__(self, cfg: StreamPETRConfig):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = VoVNet(cfg.backbone)
        self.img_neck = FPN(cfg.neck)
        self.pts_bbox_head = StreamPETRHead(cfg)

    def forward(self,
                images: torch.Tensor,         # (B, N, H, W, 3) BGR
                lidar2img: torch.Tensor,      # (B, N, 4, 4)
                state: TemporalState,
                prev_exists: torch.Tensor,    # (B,)
                timestamp: torch.Tensor,      # (B,)
                ego_pose: torch.Tensor,       # (B, 4, 4)
                ego_pose_inv: torch.Tensor,   # (B, 4, 4)
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                quant_backbone: Optional[Dict[str, Any]] = None,
                feats: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        """The images' dtype sets the image side's and the decoder's; uint8
        images are normalized with the module-level BGR mean and std and run
        in bf16 (streampetr.py:233-239). `train` turns on the decoder's
        dropouts, drawn from `generator` on the activations' device.
        `quant_backbone`, a tree of ``ops/quant.py:quantize_petr_backbone``,
        replaces the bf16 backbone with the int8 one. `feats`, the output of a
        ``forward_towers`` call the caller made, takes the place of that call."""
        if feats is None:
            feats = self.forward_towers(images, quant_backbone)
        return self.pts_bbox_head(feats, lidar2img, state, prev_exists,
                                  timestamp, ego_pose, ego_pose_inv, train,
                                  generator)

    def forward_towers(self, images: torch.Tensor,
                       quant_backbone: Optional[Dict[str, Any]] = None
                       ) -> torch.Tensor:
        """The image side of the frame: (B, N, H, W, 3) images normalized,
        the backbone (bf16, or int8 with `quant_backbone`) and the FPN at
        its one level -> (B * N, C, H16, W16)."""
        c = self.cfg
        b, n, h, w, _ = images.shape
        with span('model.backbone'):
            x = normalized(images).reshape(b * n, h, w, 3)
            if quant_backbone is not None:
                from ..ops.quant import quant_vovnet_forward, quantize_input
                stages = quant_vovnet_forward(
                    c.backbone, quant_backbone,
                    quantize_input(x, quant_backbone['s0']))
            else:
                stages = self.img_backbone(x.permute(0, 3, 1, 2))
        with span('model.neck'):
            return self.img_neck(stages, level=c.feat_level)


def normalized(images: torch.Tensor) -> torch.Tensor:
    """uint8 images normalized with the module-level BGR mean and std, in
    bf16; floating images as they are."""
    if images.is_floating_point():
        return images
    mean = constant(IMG_MEAN, torch.float32, images.device)
    std = constant(IMG_STD, torch.float32, images.device)
    return ((images.float() - mean) / std).to(torch.bfloat16)


def init_petr_state(batch: int, cfg: StreamPETRConfig,
                    device=None) -> TemporalState:
    m = cfg.memory_len

    def z(*shape):
        return torch.zeros(batch, m, *shape, device=device)

    return TemporalState(embedding=z(cfg.embed_dims), ref_points=z(3),
                         timestamp=z(1), egopose=z(4, 4), velo=z(2))


def tiny_petr_config() -> StreamPETRConfig:
    """Scaled-down config for CPU tests; the JAX package's shapes."""
    return StreamPETRConfig(
        num_classes=5, embed_dims=64, num_query=16, memory_len=24,
        topk_proposals=8, num_propagated=8, num_layers=2, num_heads=4,
        ffn_dims=128, depth_num=8, code_size=10,
        position_range=(-12., -12., -2., 12., 12., 6.),
        pc_range=(-10., -10., 0.5, 10., 10., 5.),
        backbone=BackboneConfig(
            stem_channels=(8, 8, 16), stage_conv_channels=(8, 8, 8, 8),
            stage_out_channels=(16, 24, 32, 48), layers_per_block=2,
            blocks_per_stage=(1, 1, 1, 1), remat=False),
        neck=NeckConfig(in_channels=(16, 24, 32, 48), out_channels=64),
        input_hw=(64, 96), num_cams=2, max_decode_num=12)
