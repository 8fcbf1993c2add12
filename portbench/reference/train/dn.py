"""Range-modulated 3D denoising (DN) queries (counterpart of
``far3d_tpu/train/dn.py``; reference farhead.py:315-429, 830-871).

A static budget of `dn_groups` groups x `dn_max_gt` GT slots x
`num_smp_per_gt` samples (one positive, the rest negatives); GT slots past
the real count are invalid. Noise model (farhead.py:344-361):

  positive: center + sign * (rand + offset_p) * (size/2 + trans) * noise_scale
  negative: center + sign * (rand + offset)   * log(|center| + 1)   (per axis)

Split in three so that a test can hand in the JAX package's draws and the
step can match everything in one batch: ``draw_noise`` takes the random
numbers from a ``torch.Generator``; ``build_queries`` is a deterministic
function of them that returns the DN reference points and the L1 cost of
each (group, sample slot) against each GT center; ``assign_targets`` turns
the Hungarian rows of that cost into the DN class and box targets.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import HeadConfig
from .matching import BIG_COST, hungarian_match


def draw_noise(batch: int, cfg: HeadConfig,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The draws of dn.py:57-70: rand_* ~ U[0,1), sign_* in {-1, +1}; the
    positives' (B, groups, max_gt, 3), the negatives' (B, groups,
    samples - 1, max_gt, 3)."""
    dev = generator.device
    shape_p = (batch, cfg.dn_groups, cfg.dn_max_gt, 3)
    shape_n = (batch, cfg.dn_groups, cfg.num_smp_per_gt - 1, cfg.dn_max_gt, 3)

    def sign(shape):
        return torch.randint(0, 2, shape, generator=generator,
                             device=dev).float() * 2 - 1

    return dict(rand_p=torch.rand(shape_p, generator=generator, device=dev),
                sign_p=sign(shape_p),
                rand_n=torch.rand(shape_n, generator=generator, device=dev),
                sign_n=sign(shape_n))


def build_queries(noise: Dict[str, torch.Tensor],
                  gt_boxes: torch.Tensor,     # (B, G, >=7) metric, gravity ctr
                  gt_labels: torch.Tensor,    # (B, G) int
                  gt_mask: torch.Tensor,      # (B, G) bool
                  cfg: HeadConfig, pc_range) -> Dict[str, torch.Tensor]:
    """dn.py:32-112 up to the matching. Returns ref_points (B, pad, 3) in
    [0, 1] pc-range coordinates (clamped, zero where invalid), valid
    (B, pad), the matching cost (B, groups, samples * max_gt, max_gt) and the
    GT slots it was built from (boxes, labels, mask)."""
    b = gt_labels.shape[0]
    ngroups, nsmp, gmax = cfg.dn_groups, cfg.num_smp_per_gt, cfg.dn_max_gt
    boxes = gt_boxes[:, :gmax].float()
    labels = gt_labels[:, :gmax]
    mask = gt_mask[:, :gmax].bool()
    center = boxes[..., :3]
    size = boxes[..., 3:6]

    diff_p = (size[:, None] / 2.0 + cfg.dn_noise_trans) * cfg.dn_noise_scale
    pos_center = center[:, None] + noise['sign_p'] * (
        noise['rand_p'] + cfg.dn_offset_p) * diff_p
    diff_n = torch.log(center[:, None, None].abs() + 1.0)
    neg_center = center[:, None, None] + noise['sign_n'] * (
        noise['rand_n'] + cfg.dn_offset) * diff_n
    # per-group slot layout [pos, neg_1, ..., neg_{nsmp-1}]
    all_center = torch.cat([pos_center[:, :, None], neg_center], dim=2)
    all_center = all_center.reshape(b, ngroups, nsmp * gmax, 3)
    slot_mask = mask[:, None, None].expand(b, ngroups, nsmp, gmax).reshape(
        b, ngroups, nsmp * gmax)

    cost = (all_center[..., None, :] - center[:, None, None]).abs().sum(-1)
    cost = torch.nan_to_num(cost, nan=100.0, posinf=100.0, neginf=-100.0)
    cost = torch.where(slot_mask[..., None], cost,
                       torch.full_like(cost, BIG_COST))
    cost = torch.where(mask[:, None, None, :], cost,
                       torch.full_like(cost, BIG_COST * 2))

    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=boxes.device)
    hi = torch.tensor(pc_range[3:6], dtype=torch.float32, device=boxes.device)
    ref = ((all_center - lo) / (hi - lo)).clamp(0.0, 1.0)
    ref = ref.reshape(b, ngroups * nsmp * gmax, 3)
    valid = slot_mask.reshape(b, ngroups * nsmp * gmax)
    ref = torch.where(valid[..., None], ref, torch.zeros_like(ref))
    return dict(ref_points=ref.detach(), valid=valid, cost=cost.detach(),
                boxes=gt_boxes[:, :gmax], labels=labels, mask=mask)


def assign_targets(dn: Dict[str, torch.Tensor], row_for_col: torch.Tensor,
                   cfg: HeadConfig) -> Dict[str, torch.Tensor]:
    """dn.py:89-122 after the matching: row_for_col (B, groups, max_gt), the
    matched slot of each GT. Adds labels (B, pad) (num_classes =
    background), bbox_targets (B, pad, box dims), bbox_mask (B, pad) and
    num_tgt = groups * number of valid GTs to a copy of `dn`."""
    boxes, labels, mask = dn['boxes'], dn['labels'], dn['mask']
    b, ngroups, nslots, _ = dn['cost'].shape
    dev = boxes.device
    # invalid columns scatter to a dummy slot (index nslots), dropped after
    safe_rows = torch.where(mask[:, None], row_for_col,
                            torch.full_like(row_for_col, nslots))
    cls_t = torch.full((b, ngroups, nslots + 1), cfg.num_classes,
                       dtype=torch.long, device=dev)
    cls_t.scatter_(2, safe_rows, labels[:, None].expand(b, ngroups, -1).long())
    nd = boxes.shape[-1]
    box_t = torch.zeros(b, ngroups, nslots + 1, nd, device=dev)
    box_t.scatter_(2, safe_rows[..., None].expand(-1, -1, -1, nd),
                   boxes[:, None].float().expand(b, ngroups, -1, nd))
    cls_t = cls_t[:, :, :nslots].reshape(b, ngroups * nslots)
    out = dict(dn)
    out.update(labels=cls_t,
               bbox_targets=box_t[:, :, :nslots].reshape(b, ngroups * nslots, nd),
               bbox_mask=cls_t != cfg.num_classes,
               num_tgt=float(ngroups) * mask.sum().float())
    return out


def build_dn(noise, gt_boxes, gt_labels, gt_mask, cfg: HeadConfig,
             pc_range) -> Dict[str, torch.Tensor]:
    """``build_queries`` and ``assign_targets`` with a matching of their own:
    the counterpart of the JAX package's ``build_dn_queries``. The train step
    instead matches the DN cost together with every decoder layer's cost."""
    dn = build_queries(noise, gt_boxes, gt_labels, gt_mask, cfg, pc_range)
    col_ok = dn['mask'][:, None].expand(-1, cfg.dn_groups, -1)
    rows, = hungarian_match([dn['cost']], [col_ok])
    return assign_targets(dn, rows, cfg)
