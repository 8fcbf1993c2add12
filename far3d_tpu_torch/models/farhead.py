"""FarHead: the sparse-query 3D head with a streaming temporal memory
(counterpart of ``far3d_tpu/models/farhead.py``; reference
models/dense_heads/farhead.py).

The memory queue is an explicit ``TemporalState`` passed in and returned each
frame; a scene change is the multiplicative ``prev_exists`` mask. 2D proposals
come as a static top-K with a validity mask. In training the denoising (DN)
queries, built by ``train/dn.py``, come first in the query set, behind a
block-diagonal attention mask, and their predictions are returned apart from
the real queries'. The cls and reg branches are one instance shared by all
decoder layers, as in the reference.

Gradients stop where the JAX package stops them: at the frozen pseudo
reference points, the lifted 2D proposals (reference points and context)
and the memory written for the next frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import (DecoderConfig, DeformableAggConfig, DepthNetConfig,
                      HeadConfig, MultiDepthConfig)
from ..geometry import (denormalize_from_pc_range, inverse_sigmoid,
                        lid_bin_to_depth, nerf_positional_encoding,
                        normalize_to_pc_range, pos2posemb1d, pos2posemb3d,
                        transform_points, unproject_to_lidar)
from .decoder import Decoder
from .layers import MLN, MLP, Linear


@dataclasses.dataclass
class TemporalState:
    """Streaming memory queue (farhead.py:446-508), one slot row per batch
    lane. Reference points and ego poses are kept in the global frame between
    frames; ``pre_update_memory_fn`` aligns them into the current ego frame."""
    embedding: torch.Tensor    # (B, memory_len, C)
    ref_points: torch.Tensor   # (B, memory_len, 3) metric
    timestamp: torch.Tensor    # (B, memory_len, 1)
    egopose: torch.Tensor      # (B, memory_len, 4, 4)
    velo: torch.Tensor         # (B, memory_len, 2)


def init_state(batch: int, cfg: HeadConfig, device) -> TemporalState:
    m = cfg.memory_len

    def z(*shape):
        return torch.zeros(batch, m, *shape, device=device)

    return TemporalState(embedding=z(cfg.embed_dims), ref_points=z(3),
                         timestamp=z(1), egopose=z(4, 4), velo=z(2))


def pre_update_memory_fn(state: TemporalState, prev_exists, timestamp,
                         ego_pose_inv, pseudo_ref, num_propagated: int,
                         pc_range) -> TemporalState:
    """farhead.py:453-477: align the memory into the current ego frame, zero
    it on a scene change, seed pseudo reference points on a fresh stream."""
    b = prev_exists.shape[0]
    x = prev_exists.reshape(b, 1, 1).to(state.embedding.dtype)
    ts = (state.timestamp + timestamp.reshape(b, 1, 1)) * x
    ego = (ego_pose_inv[:, None] @ state.egopose) * x[..., None]
    ref = transform_points(state.ref_points, ego_pose_inv) * x
    emb = state.embedding * x
    velo = state.velo * x
    if num_propagated > 0:
        fresh = 1.0 - x
        pseudo = denormalize_from_pc_range(pseudo_ref.detach(), pc_range)
        ref = torch.cat([ref[:, :num_propagated] + fresh * pseudo[None],
                         ref[:, num_propagated:]], dim=1)
        eye = torch.eye(4, dtype=ego.dtype, device=ego.device)
        ego = torch.cat([ego[:, :num_propagated] + fresh[..., None] * eye,
                         ego[:, num_propagated:]], dim=1)
    return TemporalState(emb, ref, ts, ego, velo)


def post_update_memory_fn(state: TemporalState, cls_scores, bbox_preds,
                          out_dec_last, query_valid, timestamp, ego_pose,
                          topk_proposals: int, memory_len: int
                          ) -> TemporalState:
    """farhead.py:479-508: prepend the top-k scored valid queries and
    re-express the queue in the global frame."""
    score = torch.sigmoid(cls_scores).amax(dim=-1)             # (B, Q)
    score = torch.where(query_valid, score, torch.full_like(score, -1.0))
    _, top_idx = torch.topk(score, topk_proposals, dim=1)      # (B, k)
    b, k = top_idx.shape

    def take(a):
        idx = top_idx.reshape(b, k, *([1] * (a.dim() - 2)))
        return torch.gather(a.detach(), 1, idx.expand(b, k, *a.shape[2:]))

    rec_ref = take(bbox_preds[..., :3])
    rec_velo = take(bbox_preds[..., -2:])
    rec_emb = take(out_dec_last)
    rec_ts = torch.zeros(b, k, 1, dtype=state.timestamp.dtype,
                         device=top_idx.device)
    rec_ego = torch.eye(4, dtype=state.egopose.dtype, device=top_idx.device
                        ).expand(b, k, 4, 4)

    def push(new, old):
        return torch.cat([new, old], dim=1)[:, :memory_len]

    emb = push(rec_emb, state.embedding)
    ref = transform_points(push(rec_ref, state.ref_points), ego_pose)
    ts = push(rec_ts, state.timestamp) - timestamp.reshape(b, 1, 1)
    ego = ego_pose[:, None] @ push(rec_ego, state.egopose)
    velo = push(rec_velo, state.velo)
    return TemporalState(emb, ref, ts, ego, velo)


def build_query2d_proposals(proposals: Dict[str, torch.Tensor],
                            depth_probs: torch.Tensor,
                            feat_flatten: torch.Tensor,
                            lidar2img: torch.Tensor,
                            pad_hw: Tuple[int, int],
                            depth_cfg: DepthNetConfig,
                            md_cfg: MultiDepthConfig,
                            pc_range,
                            threshold: float,
                            gt_depth_bins: Optional[torch.Tensor] = None,
                            use_gt_depth: bool = False):
    """Lift the 2D proposals to 3D queries (farhead.py:710-827).

    proposals: output of heads2d.select_proposals; depth_probs
    (B, N, H8*W8, D+1); feat_flatten (B, N, L_total, C), the aligned features;
    lidar2img (B, N, 4, 4). Returns (ref_points (B, K*S, 3) in
    pc-range-normalized coordinates, context (B, K*S, C+1), valid (B, K*S)),
    with S depth slots interleaved per proposal, all without gradient. With
    `use_gt_depth` and gt_depth_bins (B, N, H8*W8) given, each proposal gets
    one slot at its GT depth bin (train time, farhead.py:585-592); otherwise S
    = multi-depth top-k slots of the predicted distribution.
    """
    cam_idx = proposals['cam_idx']
    b, k = cam_idx.shape
    boxes = proposals['boxes']
    # the log-odds in f32: in bf16, 1 - 1e-5 rounds to 1, so a saturated
    # score (any logit pair above about 6.2) would give an infinite log-odds
    # and a NaN context (the JAX package clips in the scores' dtype,
    # farhead.py:154)
    scores = proposals['scores'][..., 0].float().clamp(1e-5, 1 - 1e-5)
    valid = proposals['valid']
    topk = max(md_cfg.topk, 1)
    pad_h, pad_w = pad_hw
    h8 = pad_h // depth_cfg.stride
    w8 = pad_w // depth_cfg.stride

    # box center on the stride-8 grid (farhead.py:736-742)
    cx = torch.round(boxes[..., 0] / depth_cfg.stride).clamp(0, w8 - 1)
    cy = torch.round(boxes[..., 1] / depth_cfg.stride).clamp(0, h8 - 1)
    flat8 = (cy * w8 + cx).long()                              # (B, K)
    bidx = torch.arange(b, device=cam_idx.device)[:, None]

    probs = depth_probs[bidx, cam_idx, flat8]                   # (B, K, D+1)
    log_odds = (torch.log(scores / (1 - scores))
                - math.log(threshold / (1 - threshold)))

    if use_gt_depth and gt_depth_bins is not None:
        bins = gt_depth_bins[bidx, cam_idx, flat8].float()[..., None]
        dweights = torch.ones_like(bins)
        extra_valid = torch.zeros(b, k, topk - 1, dtype=torch.bool,
                                  device=bins.device)
    else:
        vals, idxs = torch.topk(probs, topk, dim=-1)            # (B, K, S)
        bins = idxs.float()
        dweights = vals / vals[..., :1].clamp(min=1e-9)         # rescale (:778)
        bs = 2.0 * (depth_cfg.depth_max - depth_cfg.depth_min) / (
            depth_cfg.num_depth_bins * (1 + depth_cfg.num_depth_bins))
        range_min_bin = int(-0.5 + 0.5 * (1.0 + 8.0 * (
            md_cfg.range_min - depth_cfg.depth_min) / bs) ** 0.5)
        extra_valid = (idxs[..., :1] >= range_min_bin).expand(b, k, topk - 1)
    n_slots = bins.shape[-1]

    depth = lid_bin_to_depth(bins, depth_cfg.depth_min, depth_cfg.depth_max,
                             depth_cfg.num_depth_bins)          # (B, K, S)
    # unproject each depth slot through img2lidar (farhead.py:792-811)
    img2lidar = torch.linalg.inv(lidar2img.float())
    i2l = img2lidar[bidx, cam_idx]                              # (B, K, 4, 4)
    pts = unproject_to_lidar(boxes[:, :, None, :2], depth[..., None],
                             i2l[:, :, None])                   # (B, K, S, 3)
    ref = normalize_to_pc_range(pts, pc_range)

    # context = aligned FPN feature at the proposal plus the depth-weighted
    # score log-odds channel (farhead.py:773-786)
    ctx = feat_flatten[bidx, cam_idx, proposals['flat_idx']]   # (B, K, C)
    ctx = ctx[:, :, None, :].expand(b, k, n_slots, ctx.shape[-1])
    lo = (log_odds[..., None] * dweights).to(ctx.dtype)        # (B, K, S)
    ctx = torch.cat([ctx, lo[..., None]], dim=-1)

    slot_valid = torch.cat([valid[..., None], valid[..., None] & extra_valid],
                           dim=-1)[..., :n_slots]
    return (ref.reshape(b, k * n_slots, 3).detach(),
            ctx.reshape(b, k * n_slots, -1).detach(),
            slot_valid.reshape(b, k * n_slots))


def build_attn_mask(pad_size: int, group_size: int, num_query: int, k2d: int,
                    num_prop: int, mem_tail: int,
                    proposal_valid: torch.Tensor,
                    dn_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-diagonal DN mask plus blocked invalid keys (farhead.py:226-254);
    True = blocked. Query layout [DN (pad_size), learned, proposals (k2d),
    propagated]; keys add the memory tail. A DN key is visible only to
    queries of its own DN group; invalid DN slots and invalid proposals are
    blocked for every query. Returns (B, Q, K)."""
    b = proposal_valid.shape[0]
    dev = proposal_valid.device
    nq = pad_size + num_query + k2d + num_prop
    nk = nq + mem_tail
    qi = torch.arange(nq, device=dev)
    ki = torch.arange(nk, device=dev)
    gs = max(group_size, 1)
    q_group = torch.where(qi < pad_size, qi // gs, torch.full_like(qi, -1))
    k_group = torch.where(ki < pad_size, ki // gs, torch.full_like(ki, -2))
    blocked = (k_group[None, :] >= 0) & (q_group[:, None] != k_group[None, :])
    keys = torch.zeros(b, nk, dtype=torch.bool, device=dev)
    if dn_valid is not None and pad_size > 0:
        keys[:, :pad_size] = ~dn_valid
    p0 = pad_size + num_query
    keys[:, p0:p0 + k2d] = ~proposal_valid
    return blocked[None] | keys[:, None, :]


class FarHead(nn.Module):
    """FarHead (farhead.py:257-451). Child names are the reference
    checkpoint's (``pts_bbox_head.*``)."""

    def __init__(self, head: HeadConfig, decoder: DecoderConfig,
                 deform: DeformableAggConfig, depthnet: DepthNetConfig,
                 pc_range: Sequence[float],
                 spatial_shapes: Sequence[Tuple[int, int]],
                 pad_hw: Tuple[int, int], threshold_2d: float = 0.1):
        super().__init__()
        self.head = head
        self.depthnet = depthnet
        self.pc_range = tuple(pc_range)
        self.pad_hw = pad_hw
        self.threshold_2d = threshold_2d
        c = head.embed_dims
        self.reference_points = nn.Embedding(head.num_query, 3)
        self.pseudo_reference_points = nn.Embedding(head.num_propagated, 3)
        self.spatial_alignment = MLN(14, c, use_ln=False)
        # inputs: pos2posemb3d (3 x 128) of the reference points
        self.query_embedding = MLP((c, c), in_dim=384)
        self.context_embed = MLP((c, c), in_dim=c + 1)
        self.ego_pose_pe = MLN(180, c)
        self.ego_pose_memory = MLN(180, c)
        self.time_embedding = nn.Sequential(Linear(256, c),
                                            nn.LayerNorm(c, eps=1e-5))
        self.transformer = nn.ModuleDict({'decoder': Decoder(
            decoder, deform, spatial_shapes, pad_hw, pc_range)})
        self.cls_branches = nn.ModuleList([nn.Sequential(
            Linear(c, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU(),
            Linear(c, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU(),
            Linear(c, head.num_classes))])
        self.reg_branches = nn.ModuleList([nn.Sequential(
            Linear(c, c), nn.ReLU(), Linear(c, c), nn.ReLU(),
            Linear(c, head.code_size))])

    def forward(self,
                feat_flatten: torch.Tensor,      # (B*N, L_total, C) raw
                lidar2img: torch.Tensor,         # (B, N, 4, 4)
                intrinsics: torch.Tensor,        # (B, N, 4, 4)
                extrinsics: torch.Tensor,        # (B, N, 4, 4)
                state: TemporalState,
                prev_exists: torch.Tensor,       # (B,)
                timestamp: torch.Tensor,         # (B,)
                ego_pose: torch.Tensor,          # (B, 4, 4)
                ego_pose_inv: torch.Tensor,      # (B, 4, 4)
                proposals: Optional[Dict[str, torch.Tensor]] = None,
                depth_probs: Optional[torch.Tensor] = None,
                gt_depth_bins: Optional[torch.Tensor] = None,
                dn_ref_points: Optional[torch.Tensor] = None,   # (B, pad, 3)
                dn_valid: Optional[torch.Tensor] = None,        # (B, pad)
                use_gt_depth: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """Returns the real queries' ``all_cls_scores`` (L, B, Q, ncls),
        ``all_bbox_preds`` (L, B, Q, code), ``query_valid`` and the next
        ``state``; with DN queries also ``dn_cls_scores`` and
        ``dn_bbox_preds`` (L, B, pad, ...), else None for both."""
        c = self.head
        bn, l_total, ch = feat_flatten.shape
        b = lidar2img.shape[0]
        n = bn // b

        state = pre_update_memory_fn(
            state, prev_exists, timestamp, ego_pose_inv,
            self.pseudo_reference_points.weight, c.num_propagated,
            self.pc_range)

        # spatial alignment over the flattened features (farhead.py:553-565):
        # condition = [fx/1e3, fy/1e3, extrinsics[:3, :4]] (14 dims)
        intr = intrinsics / 1e3
        mln_in = torch.cat([intr[..., 0, 0:1], intr[..., 1, 1:2],
                            extrinsics[..., :3, :].reshape(b, n, 12)], dim=-1)
        feat_flatten = self.spatial_alignment(
            feat_flatten, mln_in.reshape(bn, 1, 14).to(feat_flatten.dtype))

        # --- query set: [DN, learned, 2D proposals, propagated] -----------
        pad_size = 0 if dn_ref_points is None else dn_ref_points.shape[1]
        reference_points = self.reference_points.weight[None].expand(
            b, c.num_query, 3)
        if pad_size:
            reference_points = torch.cat(
                [dn_ref_points.to(reference_points.dtype), reference_points],
                dim=1)
        k2d, ctx2d = 0, None
        if c.add_query_from_2d and proposals is not None:
            ref2d, ctx2d, prop_valid = build_query2d_proposals(
                proposals, depth_probs,
                feat_flatten.reshape(b, n, l_total, ch), lidar2img,
                self.pad_hw, self.depthnet, c.multi_depth, self.pc_range,
                self.threshold_2d, gt_depth_bins, use_gt_depth)
            k2d = ref2d.shape[1]
            reference_points = torch.cat(
                [reference_points, ref2d.to(reference_points.dtype)], dim=1)
        else:
            prop_valid = torch.zeros(b, 0, dtype=torch.bool,
                                     device=feat_flatten.device)

        query_pos = self.query_embedding(pos2posemb3d(reference_points))
        tgt = torch.zeros_like(query_pos)
        if ctx2d is not None:
            ctx_emb = self.context_embed(ctx2d.to(tgt.dtype))
            tgt = torch.cat([tgt[:, :pad_size + c.num_query], ctx_emb], dim=1)

        # --- temporal alignment (farhead.py:284-313) ------------------------
        temp_ref_norm = normalize_to_pc_range(state.ref_points, self.pc_range)
        temp_pos = self.query_embedding(pos2posemb3d(temp_ref_norm))
        temp_memory = state.embedding
        if c.with_ego_pos:
            nq_cur = reference_points.shape[1]
            rec_motion = torch.cat([
                torch.zeros_like(reference_points[..., :3]),
                torch.eye(4, dtype=tgt.dtype, device=tgt.device)[:3, :]
                .reshape(1, 1, 12).expand(b, nq_cur, 12)], dim=-1)
            rec_motion = nerf_positional_encoding(rec_motion.to(tgt.dtype))
            tgt = self.ego_pose_memory(tgt, rec_motion)
            query_pos = self.ego_pose_pe(query_pos, rec_motion)
            mem_motion = torch.cat(
                [state.velo, state.timestamp,
                 state.egopose[..., :3, :].reshape(b, c.memory_len, 12)],
                dim=-1)
            mem_motion = nerf_positional_encoding(mem_motion.to(tgt.dtype))
            temp_pos = self.ego_pose_pe(temp_pos, mem_motion)
            temp_memory = self.ego_pose_memory(temp_memory, mem_motion)

        query_pos = query_pos + self.time_embedding(
            pos2posemb1d(torch.zeros_like(reference_points[..., :1])))
        temp_pos = temp_pos + self.time_embedding(pos2posemb1d(state.timestamp))

        # append the propagated queries (farhead.py:305-311)
        np_ = c.num_propagated
        if np_ > 0:
            tgt = torch.cat([tgt, temp_memory[:, :np_]], dim=1)
            query_pos = torch.cat([query_pos, temp_pos[:, :np_]], dim=1)
            reference_points = torch.cat(
                [reference_points, temp_ref_norm[:, :np_]], dim=1)
            temp_memory = temp_memory[:, np_:]
            temp_pos = temp_pos[:, np_:]

        attn_mask = build_attn_mask(
            pad_size, c.dn_max_gt * c.num_smp_per_gt, c.num_query, k2d, np_,
            temp_memory.shape[1], prop_valid, dn_valid)

        outs_dec = self.transformer['decoder'](
            tgt, query_pos, feat_flatten, temp_memory, temp_pos,
            reference_points, lidar2img, attn_mask, train, generator)
        outs_dec = torch.nan_to_num(outs_dec.float())

        all_cls = self.cls_branches[0](outs_dec)              # (Lyr, B, Q, ncls)
        tmp = self.reg_branches[0](outs_dec)                  # (Lyr, B, Q, code)
        ref_logit = inverse_sigmoid(reference_points.float())
        xyz = torch.sigmoid(tmp[..., :3] + ref_logit[None])
        xyz = denormalize_from_pc_range(xyz, self.pc_range)
        all_bbox = torch.cat([xyz, tmp[..., 3:]], dim=-1)

        # --- memory update and outputs, the DN part excluded (:434-450) -----
        query_valid = torch.cat([
            torch.ones(b, c.num_query, dtype=torch.bool, device=prop_valid.device),
            prop_valid,
            torch.ones(b, np_, dtype=torch.bool, device=prop_valid.device)],
            dim=1)
        real_cls, real_bbox = all_cls[:, :, pad_size:], all_bbox[:, :, pad_size:]
        new_state = post_update_memory_fn(
            state, real_cls[-1], real_bbox[-1], outs_dec[-1][:, pad_size:],
            query_valid, timestamp, ego_pose, c.topk_proposals, c.memory_len)
        return {'all_cls_scores': real_cls, 'all_bbox_preds': real_bbox,
                'dn_cls_scores': all_cls[:, :, :pad_size] if pad_size else None,
                'dn_bbox_preds': all_bbox[:, :, :pad_size] if pad_size else None,
                'query_valid': query_valid, 'state': new_state}
