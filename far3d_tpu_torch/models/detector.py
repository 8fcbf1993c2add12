"""Far3D top-level detector (counterpart of ``far3d_tpu/models/detector.py``;
reference models/detectors/far3d.py).

Per frame: VoVNet -> FPN -> YOLOX 2D head + depth net -> static top-K
proposals -> FarHead (2D->3D lifting, temporal memory, decoder) -> outputs.
The temporal memory is an explicit input and output (``TemporalState``).
Child names are the reference checkpoint's top-level prefixes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import Far3DConfig
from ..geometry import denormalize_bbox
from .farhead import FarHead, TemporalState
from .heads2d import YoloxHead2D, select_proposals
from .vovnet import FPN, VoVNet


def level_shapes(cfg: Far3DConfig) -> Tuple[Tuple[int, int], ...]:
    """FPN level shapes: successive stride-2 stages => ceil division."""
    h, w = cfg.data.input_hw
    return tuple((-(-h // s), -(-w // s)) for s in cfg.strides)


class Far3D(nn.Module):
    def __init__(self, cfg: Far3DConfig):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = VoVNet(cfg.backbone)
        self.img_neck = FPN(cfg.neck)
        self.img_roi_head = YoloxHead2D(cfg.roi2d, cfg.depthnet)
        self.pts_bbox_head = FarHead(
            cfg.head, cfg.decoder, cfg.deform, cfg.depthnet, cfg.pc_range,
            level_shapes(cfg), cfg.data.input_hw, cfg.roi2d.threshold_score)

    def forward(self,
                images: torch.Tensor,         # (B, N, H, W, 3) BGR
                lidar2img: torch.Tensor,      # (B, N, 4, 4)
                intrinsics: torch.Tensor,     # (B, N, 4, 4)
                extrinsics: torch.Tensor,     # (B, N, 4, 4)
                state: TemporalState,
                prev_exists: torch.Tensor,    # (B,)
                timestamp: torch.Tensor,      # (B,)
                ego_pose: torch.Tensor,       # (B, 4, 4)
                ego_pose_inv: torch.Tensor,   # (B, 4, 4)
                gt_depth_bins: Optional[torch.Tensor] = None,  # (B, N, H8*W8)
                dn_ref_points: Optional[torch.Tensor] = None,  # (B, pad, 3)
                dn_valid: Optional[torch.Tensor] = None,       # (B, pad)
                use_gt_depth: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                quant_backbone: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """The images' dtype sets the dtype of the image side (backbone, FPN,
        2D head and the sampled feature pyramid); the query side is f32.
        uint8 images are normalized here and run in bf16.

        `train` (detector.py:35-98) switches the YOLOX towers' BN to batch
        statistics and turns on the decoder's dropouts, drawn from
        `generator` (on the activations' device); `gt_depth_bins` with
        `use_gt_depth` places the 2D proposals at their GT depth; `dn_*` are
        the denoising queries of ``train/dn.py``. The raw 2D head maps come
        back as ``outs2d`` for the 2D loss. `quant_backbone`, a tree of
        ``ops/quant.py`` (``quantize_detector_backbone``), replaces the bf16
        backbone with the int8 one: the serving mode."""
        b, n = images.shape[:2]
        feats, outs2d = camera_towers(self, normalize_images(images, self.cfg),
                                      train, quant_backbone)
        return self.forward_head(
            feats, outs2d, b, n, lidar2img, intrinsics, extrinsics, state,
            prev_exists, timestamp, ego_pose, ego_pose_inv, gt_depth_bins,
            dn_ref_points, dn_valid, use_gt_depth, train, generator)

    def forward_head(self, feats, outs2d, b, n, lidar2img, intrinsics,
                     extrinsics, state, prev_exists, timestamp, ego_pose,
                     ego_pose_inv, gt_depth_bins=None, dn_ref_points=None,
                     dn_valid=None, use_gt_depth=False, train=False,
                     generator=None) -> Dict[str, Any]:
        """The cross-camera part of the frame, after ``camera_towers``:
        the joint top-K proposals, FarHead and its decoder over all cameras.
        `feats` and `outs2d` hold the b * n images camera-minor."""
        cfg = self.cfg
        proposals = select_proposals(outs2d, b, n, cfg.strides,
                                     cfg.roi2d.num_proposals_2d,
                                     cfg.roi2d.threshold_score)
        dl = outs2d['depth_logit']
        depth_probs = dl.softmax(dim=-1).reshape(b, n, -1, dl.shape[-1])

        feat_flatten = torch.cat(
            [f.permute(0, 2, 3, 1).reshape(b * n, -1, f.shape[1])
             for f in feats], dim=1)

        head_out = self.pts_bbox_head(
            feat_flatten, lidar2img, intrinsics, extrinsics, state,
            prev_exists, timestamp, ego_pose, ego_pose_inv,
            proposals=proposals, depth_probs=depth_probs,
            gt_depth_bins=gt_depth_bins, dn_ref_points=dn_ref_points,
            dn_valid=dn_valid, use_gt_depth=use_gt_depth, train=train,
            generator=generator)
        head_out['outs2d'] = outs2d
        head_out['proposals'] = proposals
        return head_out


def normalize_images(images: torch.Tensor, cfg: Far3DConfig) -> torch.Tensor:
    """(B, N, H, W, 3) images -> (B * N, H, W, 3) model input: uint8
    transport (detector.py:55-61) normalized on the device and cast to bf16,
    as the JAX package casts; float images pass as they are."""
    b, n, h, w, _ = images.shape
    if not images.is_floating_point():
        mean = torch.tensor(cfg.data.img_mean, device=images.device)
        std = torch.tensor(cfg.data.img_std, device=images.device)
        images = ((images.float() - mean) / std).to(torch.bfloat16)
    return images.reshape(b * n, h, w, 3)


def camera_towers(towers: nn.Module, x: torch.Tensor, train: bool = False,
                  quant_backbone: Optional[Dict[str, Any]] = None):
    """The per-camera part of the frame on (BN, H, W, 3) images: the
    backbone (bf16, or int8 with `quant_backbone`), the FPN, the YOLOX 2D
    head and the depth net of `towers` (a ``Far3D``, or a replica holding
    its ``img_backbone``, ``img_neck`` and ``img_roi_head``). Returns
    (4 x (BN, C, Hl, Wl) features, the 2D head's maps)."""
    if quant_backbone is not None:
        # int8 serving path: NHWC int8 from the normalized images
        from ..ops.quant import quant_vovnet_forward, quantize_input
        stages = quant_vovnet_forward(
            towers.img_backbone.cfg, quant_backbone,
            quantize_input(x, quant_backbone['s0']))
    else:
        # NHWC -> NCHW shape; on the card this is channels_last in memory
        stages = towers.img_backbone(x.permute(0, 3, 1, 2))
    feats = towers.img_neck(stages)                      # 4 x (BN, C, Hl, Wl)
    return feats, towers.img_roi_head(feats, train)


def decode_detections(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                      query_valid: torch.Tensor, cfg: Far3DConfig
                      ) -> Dict[str, torch.Tensor]:
    """NMS-free decode for the Far3D head."""
    return decode_boxes(cls_scores, bbox_preds, query_valid,
                        cfg.head.max_decode_num, cfg.head.post_center_range)


def decode_boxes(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                 query_valid: torch.Tensor, max_decode_num: int,
                 post_center_range: Sequence[float]) -> Dict[str, torch.Tensor]:
    """NMS-free decode (nms_free_coder.py:39-91): flat top-K over
    (query x class) sigmoid scores, gravity-center z shifted to the bottom,
    the post-range test returned as a validity flag.

    cls_scores (B, Q, ncls) last-layer logits; bbox_preds (B, Q, code) with
    metric xyz. Returns boxes (B, K, 9) [x,y,z(bottom),w,l,h,yaw,vx,vy],
    scores (B, K), labels (B, K), valid (B, K), query_idx (B, K).
    """
    b, q, ncls = cls_scores.shape
    scores = torch.sigmoid(cls_scores)
    scores = torch.where(query_valid[..., None], scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = torch.topk(scores.reshape(b, q * ncls), max_decode_num,
                                 dim=1)
    labels = idx % ncls
    qidx = idx // ncls
    code = torch.gather(bbox_preds, 1,
                        qidx[..., None].expand(b, max_decode_num,
                                               bbox_preds.shape[-1]))
    boxes = denormalize_bbox(code.float())
    if boxes.shape[-1] == 7:
        boxes = torch.cat([boxes, boxes.new_zeros(*boxes.shape[:-1], 2)], dim=-1)
    boxes = torch.cat([boxes[..., :2], boxes[..., 2:3] - 0.5 * boxes[..., 5:6],
                       boxes[..., 3:]], dim=-1)
    pcr = torch.tensor(post_center_range, dtype=code.dtype, device=code.device)
    center = code[..., :3]
    in_range = ((center >= pcr[:3]).all(-1) & (center <= pcr[3:6]).all(-1))
    return {'boxes': boxes, 'scores': top_scores, 'labels': labels,
            'valid': in_range & (top_scores > 0), 'query_idx': qidx}
