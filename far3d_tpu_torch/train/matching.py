"""Hungarian matching for the set losses (counterpart of
``far3d_tpu/train/matching.py``).

The reference runs scipy's ``linear_sum_assignment`` on the host per sample
per decoder layer (hungarian_assigner_3d.py:73-82). The JAX package uses an
on-device auction only because its TPU runtime has no host callbacks; the
port matches on the host with scipy, the exact solver, and moves every cost
matrix of a step to the host in one copy (``hungarian_match``), so a step
synchronizes once for matching, not once per layer.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

BIG_COST = 1e4


def lsa_host(cost: np.ndarray) -> np.ndarray:
    """Batched scipy Hungarian (matching.py:31-44): cost (..., R, C) with
    R >= C -> matched row per column (..., C) int64."""
    from scipy.optimize import linear_sum_assignment
    cost = np.nan_to_num(np.asarray(cost, np.float32), nan=100.0,
                         posinf=100.0, neginf=-100.0)
    batch_shape = cost.shape[:-2]
    r, c = cost.shape[-2:]
    flat = cost.reshape(-1, r, c)
    out = np.zeros((flat.shape[0], c), np.int64)
    for i in range(flat.shape[0]):
        rows, cols = linear_sum_assignment(flat[i])
        out[i, cols] = rows
    return out.reshape(*batch_shape, c)


def hungarian_match(costs: Sequence[torch.Tensor],
                    col_valid: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each cost (..., R, C) -> matched row per column (..., C), on the
    cost's device. Invalid columns (col_valid (..., C) False) get the
    constant cost BIG_COST, which cannot change the optimum over the valid
    ones; their rows are meaningless. All costs go to the host in one copy
    and the results come back in one."""
    masked = [torch.where(v[..., None, :], c.detach().float(),
                          torch.full_like(c, BIG_COST, dtype=torch.float32))
              for c, v in zip(costs, col_valid)]
    host = torch.cat([m.reshape(-1) for m in masked]).cpu().numpy()
    rows, off = [], 0
    for m in masked:
        rows.append(lsa_host(host[off:off + m.numel()].reshape(m.shape)))
        off += m.numel()
    flat = torch.from_numpy(np.concatenate([r.reshape(-1) for r in rows]))
    flat = flat.to(costs[0].device)
    out, off = [], 0
    for r in rows:
        out.append(flat[off:off + r.size].reshape(r.shape))
        off += r.size
    return out


def focal_cls_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                   weight: float = 2.0, alpha: float = 0.25,
                   gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """mmdet FocalLossCost (matching.py:146-155), batched: logits
    (B, Q, ncls) x labels (B, G) -> (B, Q, G)."""
    p = cls_logits.sigmoid()
    neg = -(1 - p + eps).log() * (1 - alpha) * p ** gamma
    pos = -(p + eps).log() * alpha * (1 - p) ** gamma
    idx = gt_labels[:, None, :].expand(-1, p.shape[1], -1)
    return (pos.gather(2, idx) - neg.gather(2, idx)) * weight


def l1_bbox_cost(bbox_pred: torch.Tensor, gt_norm: torch.Tensor,
                 weight: float = 0.25) -> torch.Tensor:
    """BBox3DL1Cost (matching.py:158-162), batched: L1 distance over the
    first 8 code dims, (B, Q, code) x (B, G, code) -> (B, Q, G)."""
    diff = (bbox_pred[:, :, None, :8] - gt_norm[:, None, :, :8]).abs()
    return diff.sum(-1) * weight
