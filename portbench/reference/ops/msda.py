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

``msda_reference`` is the plain version, differentiable by autograd, and
``msda_backward_reference`` its plain backward. ``hit_records``,
``segment_starts`` and ``dval_segments`` are the value gradient's bucketing:
the plain versions of the kernels that list every corner hit by value row
and find each row's run, around the stable torch sort that the CUDA value
gradient runs between its kernels (``ops/msda_cuda.py:msda_dval``). ``msda``
routes by device: a
CPU tensor takes the plain version, a CUDA tensor launches the hand-written
kernels (``ops/msda_cuda.py``: the forward, and in the backward the value and
attention gradients) or raises. Nothing sends a CUDA tensor to the plain
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


def msda_backward_reference(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            loc: torch.Tensor,
                            weights: torch.Tensor,
                            grad_out: torch.Tensor):
    """Plain backward: ``torch.autograd.grad`` through ``msda_reference`` in
    f32 -> (d_value in the value's dtype, d_loc f32, d_weights f32). The
    value gradient is accumulated in f32 and cast once, as the JAX package's
    backward does (msda_pallas.py:721-722)."""
    with torch.enable_grad():
        v, l, w = [t.detach().float().requires_grad_()
                   for t in (value, loc, weights)]
        out = msda_reference(v, spatial_shapes, l, w)
        d_v, d_l, d_w = torch.autograd.grad(out, (v, l, w), grad_out.float())
    return d_v.to(value.dtype), d_l, d_w


def dval_key_dtype(rows: int) -> torch.dtype:
    """int16 where the keys 0..rows fit (a stable sort then takes two radix
    passes, not four), else int32."""
    return torch.int16 if rows <= torch.iinfo(torch.int16).max else torch.int32


def hit_records(loc: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]):
    """The corner slots of every (camera, query, level, point), as the
    kernel ``msda_dval_records`` writes them: slot
    ((b * Q + q) * L + l) * P + p) * 4 + corner holds a key, the corner's
    row in its camera's value rows, start(l) + row, or ``rows`` where its
    bilinear weight is zero, and that weight, the keys in
    ``dval_key_dtype(rows)``. Returns (keys, bw f32), both
    (B * Q * L * P * 4,)."""
    rows = sum(h * w for h, w in spatial_shapes)
    keys, bws, start = [], [], 0
    for h, w in spatial_shapes:
        idx, bw = _corner_data(loc.float(), h, w)        # (B, Q, P, 4)
        keys.append(torch.where(bw != 0, start + idx, rows))
        bws.append(bw)
        start += h * w
    return (torch.stack(keys, dim=2).reshape(-1).to(dval_key_dtype(rows)),
            torch.stack(bws, dim=2).reshape(-1))


def segment_starts(sorted_keys: torch.Tensor, order: torch.Tensor,
                   num_cams: int, rows: int) -> torch.Tensor:
    """The plain version of the kernel ``msda_dval_starts``. Sorted by key
    alone, the hits of value row r of camera b form one run, the runs in the
    order of their segment id r * num_cams + b (the slots, which are
    camera-major, keep each key's records in camera order). Returns starts
    int32 (num_cams * rows + 1,): segment c's records are
    order[starts[c]:starts[c + 1]], and starts[-1] is the number of hits;
    the records with the sentinel key sort after them."""
    n_seg = num_cams * rows
    cam = order // max(order.numel() // num_cams, 1)
    seg = (sorted_keys.long() * num_cams + cam).clamp(max=n_seg)
    bounds = torch.arange(n_seg + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds, out_int32=True)


def dval_segments(keys: torch.Tensor, num_cams: int, rows: int):
    """The value gradient's bucketing of ``hit_records``' keys: a stable
    sort, so the hits of one value row form one run ordered by slot, never
    by arrival, then ``segment_starts``. Returns (sorted_keys, order int64:
    the slot of each sorted record, starts)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, order, segment_starts(sorted_keys, order, num_cams,
                                              rows)


def msda(value: torch.Tensor,
         spatial_shapes: Sequence[Tuple[int, int]],
         loc: torch.Tensor,
         weights: torch.Tensor) -> torch.Tensor:
    """The plain version on every device."""
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
