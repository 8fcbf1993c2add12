"""FarHead set-prediction losses (counterpart of
``far3d_tpu/train/losses3d.py``; reference farhead.py:874-1221).

Per decoder layer: a Hungarian match of queries to GT boxes (focal class
cost + L1 box cost on the normalized code, hungarian_assigner_3d.py:29-91),
then a focal class loss and a weighted L1 box loss; with DN queries, the DN
terms against the DN targets. ``farhead_loss`` builds every layer's cost and
the DN cost first and matches them all as one batch of auction problems
on the device (``matching.hungarian_match``). Under data parallelism the normalizers (the
positives, the DN targets) are the global batch's (``parallel.mesh.
normalizer``), so that the ranks' averaged loss and gradient are the JAX
step's on the global batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import HeadConfig
from ..geometry import normalize_bbox
from ..parallel import mesh
from .dn import assign_targets
from .losses import sigmoid_focal_loss, weighted_l1
from .matching import BIG_COST, focal_cls_cost, hungarian_match, l1_bbox_cost


def match_cost(cls_scores: torch.Tensor,     # (B, Q, ncls) logits
               bbox_preds: torch.Tensor,     # (B, Q, code), metric xyz
               query_valid: torch.Tensor,    # (B, Q)
               gt_boxes: torch.Tensor,       # (B, G, >=7) metric
               gt_labels: torch.Tensor,      # (B, G)
               gt_mask: torch.Tensor,        # (B, G)
               cfg: HeadConfig) -> torch.Tensor:
    """One layer's matching cost (B, Q, G) (losses3d.py:41-48), no gradient."""
    with torch.no_grad():
        gt_norm = normalize_bbox(gt_boxes.float())
        cost = focal_cls_cost(cls_scores.float(), gt_labels,
                              weight=cfg.loss_cls_weight,
                              alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)
        cost = cost + l1_bbox_cost(bbox_preds.float(), gt_norm,
                                   weight=cfg.loss_bbox_weight)
        cost = torch.nan_to_num(cost, nan=100.0, posinf=100.0, neginf=-100.0)
        cost = torch.where(query_valid[..., None], cost,
                           torch.full_like(cost, BIG_COST + 100.0))
        return torch.where(gt_mask.bool()[:, None, :], cost,
                           torch.full_like(cost, BIG_COST))


def targets_from_match(row_for_col: torch.Tensor, query_valid: torch.Tensor,
                       gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                       gt_mask: torch.Tensor, cfg: HeadConfig):
    """losses3d.py:59-69: scatter the matched GT labels and boxes onto their
    queries (invalid GT columns go to a dropped dummy query). Returns
    (labels (B, Q), bbox_targets (B, Q, box dims), bbox_mask (B, Q),
    label_weights (B, Q))."""
    b, q = query_valid.shape
    nd = gt_boxes.shape[-1]
    safe_rows = torch.where(gt_mask.bool(), row_for_col,
                            torch.full_like(row_for_col, q))
    labels = torch.full((b, q + 1), cfg.num_classes, dtype=torch.long,
                        device=gt_boxes.device)
    labels.scatter_(1, safe_rows, gt_labels.long())
    bbox_t = torch.zeros(b, q + 1, nd, device=gt_boxes.device)
    bbox_t.scatter_(1, safe_rows[..., None].expand(-1, -1, nd),
                    gt_boxes.float())
    labels = labels[:, :q]
    return (labels, bbox_t[:, :q], labels != cfg.num_classes,
            query_valid.float())


def match_targets(cls_scores, bbox_preds, query_valid, gt_boxes, gt_labels,
                  gt_mask, cfg: HeadConfig):
    """One layer's Hungarian assignment (losses3d.py:29-69), matched on its
    own; ``farhead_loss`` batches all layers instead."""
    cost = match_cost(cls_scores, bbox_preds, query_valid, gt_boxes,
                      gt_labels, gt_mask, cfg)
    rows, = hungarian_match([cost], [gt_mask.bool()])
    return targets_from_match(rows, query_valid, gt_boxes, gt_labels,
                              gt_mask, cfg)


def layer_loss(cls_scores, bbox_preds, labels, bbox_targets, bbox_mask,
               label_weights, cfg: HeadConfig):
    """farhead.py:984-1050: one decoder layer's focal + L1 loss."""
    num_pos = mesh.normalizer(bbox_mask.float().sum())
    loss_cls = cfg.loss_cls_weight * sigmoid_focal_loss(
        cls_scores.float(), labels, label_weights, cfg.num_classes,
        cfg.focal_alpha, cfg.focal_gamma) / num_pos
    norm_t = normalize_bbox(bbox_targets)
    isfinite = torch.isfinite(norm_t).all(dim=-1)
    cw = torch.tensor(cfg.code_weights, device=norm_t.device)
    w = (bbox_mask & isfinite).float()[..., None] * cw
    loss_bbox = cfg.loss_bbox_weight * weighted_l1(
        bbox_preds.float()[..., :norm_t.shape[-1]], torch.nan_to_num(norm_t),
        w) / num_pos
    return torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox)


def farhead_loss(outs: Dict, gt_boxes, gt_labels, gt_mask,
                 dn: Optional[Dict], cfg: HeadConfig) -> Dict[str, torch.Tensor]:
    """The multi-layer loss with the DN terms (farhead.py:1113-1221).
    `dn` is ``train/dn.py:build_queries``'s output (its cost is matched here,
    with the layers'), or None."""
    all_cls = outs['all_cls_scores']       # (L, B, Q, ncls)
    all_bbox = outs['all_bbox_preds']      # (L, B, Q, code)
    qv = outs['query_valid']
    n_layers = all_cls.shape[0]
    gt_mask = gt_mask.bool()
    with_dn = dn is not None and outs.get('dn_cls_scores') is not None

    costs = [match_cost(all_cls[i], all_bbox[i], qv, gt_boxes, gt_labels,
                        gt_mask, cfg) for i in range(n_layers)]
    valid = [gt_mask] * n_layers
    if with_dn:
        costs.append(dn['cost'])
        valid.append(dn['mask'][:, None].expand(-1, cfg.dn_groups, -1))
    rows = hungarian_match(costs, valid)

    losses = {}
    for lyr in range(n_layers):
        labels, bbox_t, bmask, lw = targets_from_match(
            rows[lyr], qv, gt_boxes, gt_labels, gt_mask, cfg)
        lc, lb = layer_loss(all_cls[lyr], all_bbox[lyr], labels, bbox_t,
                            bmask, lw, cfg)
        tag = '' if lyr == n_layers - 1 else f'd{lyr}.'
        losses[f'{tag}loss_cls'] = lc
        losses[f'{tag}loss_bbox'] = lb

    if with_dn:
        dn = assign_targets(dn, rows[-1], cfg)
        num_tgt = mesh.normalizer(dn['num_tgt'])
        norm_t = normalize_bbox(dn['bbox_targets'])
        isfinite = torch.isfinite(norm_t).all(dim=-1)
        cw = torch.tensor(cfg.code_weights, device=norm_t.device)
        w = (dn['bbox_mask'] & isfinite & dn['valid']).float()[..., None] * cw
        lw = dn['valid'].float()
        for lyr in range(n_layers):
            lc = cfg.loss_cls_weight * sigmoid_focal_loss(
                outs['dn_cls_scores'][lyr].float(), dn['labels'], lw,
                cfg.num_classes, cfg.focal_alpha, cfg.focal_gamma) / num_tgt
            lb = cfg.loss_bbox_weight * weighted_l1(
                outs['dn_bbox_preds'][lyr].float()[..., :norm_t.shape[-1]],
                torch.nan_to_num(norm_t), w) / num_tgt
            tag = '' if lyr == n_layers - 1 else f'd{lyr}.'
            losses[f'{tag}dn_loss_cls'] = cfg.dn_weight * torch.nan_to_num(lc)
            losses[f'{tag}dn_loss_bbox'] = cfg.dn_weight * torch.nan_to_num(lb)
    return losses
