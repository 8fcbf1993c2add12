"""Loss primitives, masked and static-shape (counterpart of
``far3d_tpu/train/losses.py``): sigmoid focal loss (mmdet FocalLoss), weighted
L1, the softmax-focal DDN depth loss with its fg/bg balancer
(ddn_loss/focalloss.py, balancer.py), box IoU, the YOLOX square IoU loss and
binary cross entropy."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor, num_classes: int,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss summed over classes and weighted per element; labels ==
    num_classes is background. logits (..., C), labels (...,), weights (...,)
    -> scalar sum."""
    p = logits.sigmoid()
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].to(
        logits.dtype)
    ce_pos = -F.logsigmoid(logits)
    ce_neg = -F.logsigmoid(-logits)
    loss = (onehot * alpha * (1 - p) ** gamma * ce_pos
            + (1 - onehot) * (1 - alpha) * p ** gamma * ce_neg)
    return (loss.sum(-1) * weights).sum()


def weighted_l1(pred: torch.Tensor, target: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Sum of |pred - target| * weights (elementwise weights)."""
    return ((pred - target).abs() * weights).sum()


def softmax_focal_loss(logits: torch.Tensor, target: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Per-pixel multi-class focal loss on softmax probabilities
    (focalloss.py:55-130): -alpha * (1 - p_t)^gamma * log p_t."""
    logp = logits.log_softmax(dim=-1)
    logp_t = logp.gather(-1, target.long()[..., None])[..., 0]
    return -alpha * (1.0 - logp_t.exp()) ** gamma * logp_t


def ddn_depth_loss(depth_logits: torch.Tensor, target_bins: torch.Tensor,
                   fg_mask: torch.Tensor, fg_weight: float = 13.0,
                   bg_weight: float = 1.0, alpha: float = 0.25,
                   gamma: float = 2.0) -> torch.Tensor:
    """DDN loss (ddn_loss.py:134-163 + balancer.py:22-52): pixelwise softmax
    focal loss against the LID bin targets, fg/bg weighted, over all pixels."""
    loss = softmax_focal_loss(depth_logits, target_bins, alpha, gamma)
    w = torch.where(fg_mask.bool(), torch.full_like(loss, fg_weight),
                    torch.full_like(loss, bg_weight))
    return (loss * w).sum() / loss.numel()


def bbox_overlaps_xyxy(a: torch.Tensor, b: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Pairwise IoU of a (..., N, 4) and b (..., M, 4) xyxy boxes."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / (area_a + area_b - inter).clamp(min=eps)


def iou_loss_square(pred: torch.Tensor, target: torch.Tensor,
                    eps: float = 1e-16) -> torch.Tensor:
    """YOLOX IoU loss, mode='square' (mmdet IoULoss): 1 - iou^2 over aligned
    xyxy boxes (..., 4)."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    area_t = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    iou = inter / (area_p + area_t - inter).clamp(min=eps)
    return 1.0 - iou ** 2


def binary_cross_entropy_with_probs(p: torch.Tensor, target: torch.Tensor,
                                    eps: float = 1e-12) -> torch.Tensor:
    """BCE on probabilities (mmdet SimOTA's class cost)."""
    p = p.clamp(eps, 1 - eps)
    return -(target * p.log() + (1 - target) * (1 - p).log())


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -(target * F.logsigmoid(logits)
             + (1 - target) * F.logsigmoid(-logits))
