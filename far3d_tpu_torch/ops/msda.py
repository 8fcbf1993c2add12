"""Multi-scale deformable sampling (MSDA), the op at the heart of Far3D's
perspective-aware aggregation (mmcv MultiScaleDeformableAttnFunction as called
from detr3d_transformer.py:544-569).

Counterpart of ``far3d_tpu/ops/msda.py``, with the same contract:

  value   (B, L_total, C)   flattened multi-level features, levels in order
  spatial_shapes            static [(H_l, W_l)] per level
  loc     (B, Q, P, 2)      normalized (u, v), shared by all groups and levels
  weights (B, Q, G, L, P)   per-(group, level, point) attention weights
  -> out  (B, Q, C)         in the value's dtype

Bilinear convention (mmcv im2col): x = u * W - 0.5, y = v * H - 0.5; each
corner outside the feature map contributes zero on its own.

``msda_reference`` is the plain version. ``msda`` routes by device: a CPU
tensor takes the plain version, a CUDA tensor launches the hand-written kernel
(``ops/msda_cuda.py``) or raises. Nothing sends a CUDA tensor to the plain
version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


def _corner_data(loc: torch.Tensor, h: int, w: int):
    """The 4 bilinear corners of one level.

    loc: (..., 2) normalized (u, v). Returns idx (..., 4) int64 flat indices
    into h*w (clamped into the level) and weights (..., 4) f32 with the
    out-of-bounds corners zeroed. Corner order: (y0,x0), (y0,x0+1), (y0+1,x0),
    (y0+1,x0+1).
    """
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    idxs, ws = [], []
    for cy, cx, wgt in ((y0, x0, (1 - dy) * (1 - dx)),
                        (y0, x0 + 1, (1 - dy) * dx),
                        (y0 + 1, x0, dy * (1 - dx)),
                        (y0 + 1, x0 + 1, dy * dx)):
        valid = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        cyc = cy.clamp(0, h - 1).long()
        cxc = cx.clamp(0, w - 1).long()
        idxs.append(cyc * w + cxc)
        ws.append(torch.where(valid, wgt, torch.zeros_like(wgt)))
    return torch.stack(idxs, dim=-1), torch.stack(ws, dim=-1)


def msda_reference(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MSDA: gathers the 4 corner rows of every (level, point),
    accumulates in f32 and returns the value's dtype. Differentiable by
    autograd in value, loc and weights."""
    b, q, p, _ = loc.shape
    g = weights.shape[2]
    c = value.shape[-1]
    cg = c // g
    out = torch.zeros(b, q, g, cg, dtype=torch.float32, device=value.device)
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        idx, bw = _corner_data(loc.float(), h, w)           # (B,Q,P,4) each
        w_att = weights[:, :, :, lvl, :].float()            # (B,Q,G,P)
        val_l = value[:, offset:offset + h * w]
        for corner in range(4):
            rows = torch.gather(
                val_l, 1,
                idx[..., corner].reshape(b, q * p, 1).expand(b, q * p, c))
            rows = rows.float().reshape(b, q, p, g, cg)
            wc = w_att * bw[..., corner][:, :, None, :]
            out = out + torch.einsum('bqpgc,bqgp->bqgc', rows, wc)
        offset += h * w
    return out.reshape(b, q, c).to(value.dtype)


def msda(value: torch.Tensor,
         spatial_shapes: Sequence[Tuple[int, int]],
         loc: torch.Tensor,
         weights: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if value.is_cuda:
        from .msda_cuda import msda_cuda
        return msda_cuda(value, spatial_shapes, loc, weights)
    return msda_reference(value, spatial_shapes, loc, weights)


class MSDA(nn.Module):
    """``msda`` at fixed level shapes, as a parameter-free module so that a
    forward hook can observe its inputs (``chip_smoke.py`` captures the
    production-shape operands this way)."""

    def __init__(self, spatial_shapes: Sequence[Tuple[int, int]]):
        super().__init__()
        self.spatial_shapes = tuple(tuple(s) for s in spatial_shapes)

    def forward(self, value, loc, weights):
        return msda(value, self.spatial_shapes, loc, weights)
