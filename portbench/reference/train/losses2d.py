"""YOLOX 2D head losses with a masked, static-shape SimOTA assigner
(counterpart of ``far3d_tpu/train/losses2d.py``; reference
yolox_head.py:521-760 with mmdet's SimOTAAssigner, and the DDN depth loss).

SimOTA as the JAX package realizes it (losses2d.py:31-90), batched over
images here where JAX vmaps:
  * candidate = prior center inside a GT box or inside the 2.5-stride center
    region; pairs outside box-and-center cost +INF;
  * cost = BCE(sqrt(cls_prob), onehot) + 3 * (-log iou) + INF * invalid;
  * dynamic k per GT = clamp(int(sum of the top-10 candidate IoUs), 1, 10),
    realized as a threshold at the k-th smallest cost of the GT;
  * a prior matched to several GTs keeps the cheapest.
The assignment is discrete and carries no gradient; the matched IoU, which
scales the class target, does, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import Yolox2DConfig
from ..models.heads2d import decode_boxes, flatten_levels
from ..parallel import mesh
from .losses import (bbox_overlaps_xyxy, bce_logits,
                     binary_cross_entropy_with_probs, ddn_depth_loss,
                     iou_loss_square, weighted_l1)

INF = 1e8


def simota_assign(cls_logits: torch.Tensor,   # (BN, P, ncls)
                  obj_logits: torch.Tensor,   # (BN, P)
                  priors: torch.Tensor,       # (P, 4) x, y, stride, stride
                  decoded: torch.Tensor,      # (BN, P, 4) xyxy
                  gt_boxes: torch.Tensor,     # (BN, G, 4) xyxy
                  gt_labels: torch.Tensor,    # (BN, G)
                  gt_mask: torch.Tensor,      # (BN, G)
                  cfg: Yolox2DConfig):
    """-> (matched_gt (BN, P) index or -1, matched_iou (BN, P))."""
    p = priors.shape[0]
    gt_mask = gt_mask.bool()
    # centers with the 0.5-stride offset of the assignment (yolox_head.py:717)
    cx = (priors[:, 0] + priors[:, 2] * 0.5)[None, :, None]
    cy = (priors[:, 1] + priors[:, 3] * 0.5)[None, :, None]
    gx0, gy0 = gt_boxes[:, None, :, 0], gt_boxes[:, None, :, 1]
    gx1, gy1 = gt_boxes[:, None, :, 2], gt_boxes[:, None, :, 3]
    in_box = (cx > gx0) & (cx < gx1) & (cy > gy0) & (cy < gy1)   # (BN, P, G)
    gcx, gcy = (gx0 + gx1) / 2, (gy0 + gy1) / 2
    rx = cfg.center_radius * priors[None, :, 2:3]
    ry = cfg.center_radius * priors[None, :, 3:4]
    in_ct = ((cx > gcx - rx) & (cx < gcx + rx) & (cy > gcy - ry)
             & (cy < gcy + ry))
    valid_prior = (in_box | in_ct).any(dim=2)                    # (BN, P)
    both = in_box & in_ct

    ious = bbox_overlaps_xyxy(decoded, gt_boxes)                 # (BN, P, G)
    ious = torch.where(gt_mask[:, None, :], ious, torch.zeros_like(ious))
    with torch.no_grad():
        iou_cost = -torch.log(ious + 1e-8)
        probs = cls_logits.sigmoid() * obj_logits.sigmoid()[..., None]
        onehot = F.one_hot(gt_labels.long(), cfg.num_classes).float()
        cls_cost = binary_cross_entropy_with_probs(
            probs.clamp(1e-12, 1.0).sqrt()[:, :, None, :],
            onehot[:, None, :, :]).sum(-1)                       # (BN, P, G)
        cost = cls_cost + 3.0 * iou_cost
        cost = torch.where(both, cost, cost + INF)
        cost = torch.where(valid_prior[..., None], cost, cost + INF)
        cost = torch.where(gt_mask[:, None, :], cost,
                           torch.full_like(cost, INF * 3))

        # dynamic k: sum of the top-10 candidate IoUs per GT
        k = min(cfg.candidate_topk, p)
        cand = torch.where(both & valid_prior[..., None], ious,
                           torch.zeros_like(ious))
        topk_ious = cand.transpose(1, 2).topk(k, dim=-1).values  # (BN, G, k)
        dynamic_k = topk_ious.sum(-1).long().clamp(1, cfg.candidate_topk)
        # threshold = the k-th smallest cost per GT
        kth = cost.sort(dim=1).values.gather(1, (dynamic_k - 1)[:, None, :])
        matching = (cost <= kth) & (cost < INF)                  # (BN, P, G)
        best_gt = torch.where(matching, cost,
                              torch.full_like(cost, INF)).argmin(dim=2)
        any_match = matching.any(dim=2)
        matched_gt = torch.where(any_match, best_gt, torch.full_like(best_gt, -1))
    matched_iou = torch.where(any_match, ious.gather(2, best_gt[..., None])[..., 0],
                              torch.zeros_like(ious[..., 0]))
    return matched_gt, matched_iou


def yolox_loss(outs2d: Dict, priors: torch.Tensor,
               gt_boxes2d: torch.Tensor,      # (BN, G, 4) xyxy padded pixels
               gt_labels2d: torch.Tensor,     # (BN, G)
               gt_centers2d: torch.Tensor,    # (BN, G, 2)
               gt_mask2d: torch.Tensor,       # (BN, G)
               gt_depth_bins: torch.Tensor,   # (BN, H8*W8) int LID targets
               gt_depth_fg: torch.Tensor,     # (BN, H8*W8) bool
               cfg: Yolox2DConfig) -> Dict[str, torch.Tensor]:
    """The 2D branch's loss (yolox_head.py:521-674), in f32."""
    cls = flatten_levels(outs2d['cls_scores']).float()        # (BN, P, ncls)
    reg = flatten_levels(outs2d['bbox_preds']).float()        # (BN, P, 4)
    obj = flatten_levels(outs2d['objectnesses'])[..., 0].float()
    ctr = flatten_levels(outs2d['centers2d_offsets']).float()
    decoded = decode_boxes(priors, reg)

    matched_gt, matched_iou = simota_assign(
        cls, obj, priors, decoded, gt_boxes2d, gt_labels2d, gt_mask2d, cfg)
    pos = matched_gt >= 0
    posf = pos.float()
    # the global batch's under data parallelism (losses2d.py:100-121)
    num_total = mesh.normalizer(posf.sum())

    safe_gt = matched_gt.clamp(min=0)
    tgt_box = gt_boxes2d.gather(1, safe_gt[..., None].expand(-1, -1, 4))
    tgt_lbl = gt_labels2d.long().gather(1, safe_gt)
    tgt_ctr = gt_centers2d.gather(1, safe_gt[..., None].expand(-1, -1, 2))

    # IoU-aware class target (yolox_head.py:731-732)
    cls_t = F.one_hot(tgt_lbl, cfg.num_classes).float() * matched_iou[..., None]
    loss_cls = (bce_logits(cls, cls_t) * posf[..., None]).sum() / num_total \
        * cfg.loss_cls_weight
    loss_obj = bce_logits(obj, posf).sum() / num_total * cfg.loss_obj_weight
    loss_iou = (iou_loss_square(decoded, tgt_box) * posf).sum() / num_total \
        * cfg.loss_bbox_weight
    # L1 on the raw regression code (yolox_head.py:751-756)
    pr = priors[None]
    l1_t = torch.cat([
        ((tgt_box[..., 0:1] + tgt_box[..., 2:3]) / 2 - pr[..., 0:1]) / pr[..., 2:3],
        ((tgt_box[..., 1:2] + tgt_box[..., 3:4]) / 2 - pr[..., 1:2]) / pr[..., 3:4],
        torch.log((tgt_box[..., 2:3] - tgt_box[..., 0:1]) / pr[..., 2:3] + 1e-8),
        torch.log((tgt_box[..., 3:4] - tgt_box[..., 1:2]) / pr[..., 3:4] + 1e-8),
    ], dim=-1)
    loss_l1 = weighted_l1(reg, torch.nan_to_num(l1_t), posf[..., None]) \
        / num_total * cfg.loss_l1_weight
    ctr_t = (tgt_ctr - pr[..., :2]) / pr[..., 2:]
    loss_ctr = weighted_l1(ctr, torch.nan_to_num(ctr_t), posf[..., None]) \
        / num_total * cfg.loss_centers2d_weight

    dl = outs2d['depth_logit']
    loss_depth = ddn_depth_loss(
        dl.reshape(dl.shape[0], -1, dl.shape[-1]).float(), gt_depth_bins,
        gt_depth_fg, cfg.ddn_fg_weight, cfg.ddn_bg_weight, cfg.ddn_alpha,
        cfg.ddn_gamma) * cfg.loss_depth_weight

    return {'enc_loss_cls': loss_cls, 'enc_loss_obj': loss_obj,
            'enc_loss_iou': loss_iou, 'enc_loss_bbox': loss_l1,
            'enc_loss_centers2d': loss_ctr, 'loss_depth': loss_depth}
