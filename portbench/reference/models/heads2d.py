"""2D prior branch: YOLOX-style head, categorical depth net and the static
top-K proposal selection (counterpart of ``far3d_tpu/models/heads2d.py``).

The head takes NCHW feature maps and returns its prediction maps NHWC, the
layout of the JAX package's head, so that ``select_proposals`` and everything
after it index the same way in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DepthNetConfig, Yolox2DConfig
from .layers import BatchNorm, Conv2d, GroupNormConv


class ConvBNSwish(nn.Module):
    """conv 3x3 (no bias) -> BN (eps 1e-3, momentum 0.97) -> SiLU, the YOLOX
    tower block (yolox_head.py:197-219). The BN is trainable: batch
    statistics in training, running statistics at inference."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn = BatchNorm(out_ch, eps=1e-3, momentum=0.97)

    def forward(self, x, train: bool = False):
        return F.silu(self.bn(self.conv(x), train))


class DepthPredictor(nn.Module):
    """2x (3x3 conv + GN32 + ReLU) + 1x1 classifier -> num_bins+1 logits
    (depth_predictor.py:41-60), on the stride-8 level. The hidden width is
    256, as in the JAX package."""

    def __init__(self, in_ch: int, cfg: DepthNetConfig):
        super().__init__()
        d = 256
        self.depth_head = nn.ModuleList(
            [GroupNormConv(in_ch if i == 0 else d, d)
             for i in range(cfg.conv_layers)])
        self.depth_classifier = Conv2d(d, cfg.num_depth_bins + 1, 1)

    def forward(self, x):
        for layer in self.depth_head:
            x = layer(x)
        return self.depth_classifier(x)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class YoloxHead2D(nn.Module):
    """Per-level anchor-free 2D head (yolox_head.py:164-258): cls and reg
    towers, then 1x1 predictors for class, box, objectness and the 2D center
    offset; owns the depth net."""

    def __init__(self, cfg: Yolox2DConfig, depth_cfg: DepthNetConfig):
        super().__init__()
        self.cfg = cfg
        n_lvl = len(cfg.strides)

        def towers():
            return nn.ModuleList([nn.Sequential(*[
                ConvBNSwish(cfg.in_channels if s == 0 else cfg.feat_channels,
                            cfg.feat_channels)
                for s in range(cfg.stacked_convs)]) for _ in range(n_lvl)])

        def preds(out_ch):
            return nn.ModuleList([Conv2d(cfg.feat_channels, out_ch, 1)
                                  for _ in range(n_lvl)])

        self.multi_level_cls_convs = towers()
        self.multi_level_reg_convs = towers()
        self.multi_level_conv_cls = preds(cfg.num_classes)
        self.multi_level_conv_reg = preds(4)
        self.multi_level_conv_obj = preds(1)
        self.multi_level_conv_centers2d = preds(2)
        self.depthnet = DepthPredictor(cfg.in_channels, depth_cfg)

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False
                ) -> Dict[str, List[torch.Tensor]]:
        """feats: per-level (BN, C, H, W). Returns per-level NHWC maps and the
        stride-8 depth logits (BN, H8, W8, D+1). `train` switches the towers'
        BN to batch statistics (and updates the running ones)."""
        out = {'cls_scores': [], 'bbox_preds': [], 'objectnesses': [],
               'centers2d_offsets': []}
        for li, x in enumerate(feats):
            cf = rf = x
            for blk in self.multi_level_cls_convs[li]:
                cf = blk(cf, train)
            for blk in self.multi_level_reg_convs[li]:
                rf = blk(rf, train)
            out['cls_scores'].append(_nhwc(self.multi_level_conv_cls[li](cf)))
            out['bbox_preds'].append(_nhwc(self.multi_level_conv_reg[li](rf)))
            out['objectnesses'].append(_nhwc(self.multi_level_conv_obj[li](rf)))
            out['centers2d_offsets'].append(
                _nhwc(self.multi_level_conv_centers2d[li](rf)))
        out['depth_logit'] = _nhwc(self.depthnet(feats[0]))
        return out


def make_priors(level_hw: Sequence[Tuple[int, int]], strides: Sequence[int],
                device=None) -> torch.Tensor:
    """MlvlPointGenerator(strides, offset=0) priors with stride
    (yolox_head.py:133,403): (sum(HW), 4) of (x, y, stride, stride)."""
    priors = []
    for (h, w), s in zip(level_hw, strides):
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device) * s,
            torch.arange(w, dtype=torch.float32, device=device) * s,
            indexing='ij')
        ss = torch.full_like(xs, float(s))
        priors.append(torch.stack([xs.flatten(), ys.flatten(), ss.flatten(),
                                   ss.flatten()], dim=-1))
    return torch.cat(priors, dim=0)


def decode_boxes(priors: torch.Tensor, bbox_preds: torch.Tensor) -> torch.Tensor:
    """YOLOX box decode (yolox_head.py:491-501): (..., 4) -> xyxy."""
    xys = bbox_preds[..., :2] * priors[:, 2:] + priors[:, :2]
    whs = bbox_preds[..., 2:].exp() * priors[:, 2:]
    return torch.cat([xys - whs / 2, xys + whs / 2], dim=-1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([(b[..., 0:2] + b[..., 2:4]) / 2, b[..., 2:4] - b[..., 0:2]],
                     dim=-1)


def flatten_levels(maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """L x (BN, H, W, C) -> (BN, sum(HW), C)."""
    bn = maps[0].shape[0]
    return torch.cat([m.reshape(bn, -1, m.shape[-1]) for m in maps], dim=1)


def select_proposals(outs: Dict[str, List[torch.Tensor]], batch: int,
                     num_cams: int, strides: Sequence[int], k: int,
                     threshold: float) -> Dict[str, torch.Tensor]:
    """Static top-K proposal selection (yolox_head.py:424-467 made static).

    Score per location: sigmoid(obj) * sigmoid(max class logit), kept only at
    3x3 local maxima (-inf padding), then a fixed per-sample top-K over all
    cameras and levels with valid = score > threshold. Returns boxes (B, K, 4)
    cxcywh in padded-image pixels, scores (B, K, 1), cam_idx (B, K),
    flat_idx (B, K) into the camera's flattened levels, valid (B, K).

    Ties (many scores are exactly 0 after the local-max mask) may come out in
    another order than in the JAX package; compare by (cam, flat_idx).
    """
    sw_levels = []
    for cls_map, obj_map in zip(outs['cls_scores'], outs['objectnesses']):
        sw = torch.sigmoid(obj_map[..., 0]) * torch.sigmoid(
            cls_map.amax(dim=-1))                               # (BN, H, W)
        local_max = F.max_pool2d(sw[:, None], 3, stride=1, padding=1)[:, 0]
        sw = sw * (sw == local_max).to(sw.dtype)
        sw_levels.append(sw.reshape(sw.shape[0], -1))
    sample_weight = torch.cat(sw_levels, dim=1)                 # (BN, sumHW)

    level_hw = [tuple(m.shape[1:3]) for m in outs['cls_scores']]
    priors = make_priors(level_hw, strides, device=sample_weight.device)
    boxes = xyxy_to_cxcywh(decode_boxes(priors,
                                        flatten_levels(outs['bbox_preds'])))

    sum_hw = sample_weight.shape[1]
    scores, idx = torch.topk(sample_weight.reshape(batch, num_cams * sum_hw), k,
                             dim=1)
    boxes = boxes.reshape(batch, num_cams * sum_hw, 4)
    sel_boxes = torch.gather(boxes, 1, idx[..., None].expand(batch, k, 4))
    return {
        'boxes': sel_boxes,
        'scores': scores[..., None],
        'cam_idx': idx // sum_hw,
        'flat_idx': idx % sum_hw,
        'valid': scores > threshold,
    }
