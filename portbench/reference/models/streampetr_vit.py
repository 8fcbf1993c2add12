"""StreamPETR with the EVA-02 ViT backbone (exiawsh/StreamPETR, its ViT-L
entries), written plainly: the ViT of ``vit.py`` under ``img_backbone``, a
single-input CPFPN under ``img_neck`` (a 1x1 lateral conv and a 3x3 output
conv, both with bias, no norm or activation), then this reference's own
``StreamPETRHead``. uint8 images normalize to float32 with the BGR
``IMG_MEAN`` / ``IMG_STD`` (an assumption of the configuration: the
source normalizes RGB). There is no int8 path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import IMG_MEAN, IMG_STD
from .streampetr import StreamPETR, StreamPETRConfig, StreamPETRHead
from .vit import ViT, ViTConfig
from .vovnet import _ConvModule


@dataclasses.dataclass(frozen=True)
class CPFPNConfig:
    """StreamPETR's CPFPN on the ViT's one output."""
    in_channels: int = 1024
    out_channels: int = 256


@dataclasses.dataclass(frozen=True)
class StreamPETRViTConfig(StreamPETRConfig):
    """``StreamPETRConfig`` with the ViT and its neck in place of VoVNet and
    the FPN."""
    backbone: ViTConfig = ViTConfig()
    neck: CPFPNConfig = CPFPNConfig()
    input_hw: Tuple[int, int] = (800, 1600)


class CPFPN(nn.Module):
    def __init__(self, cfg: CPFPNConfig):
        super().__init__()
        oc = cfg.out_channels
        self.lateral_convs = nn.ModuleList(
            [_ConvModule(cfg.in_channels, oc, 1)])
        self.fpn_convs = nn.ModuleList([_ConvModule(oc, oc, 3, padding=1)])

    def forward(self, x):
        return self.fpn_convs[0](self.lateral_convs[0](x))


class StreamPETRViT(StreamPETR):
    """ViT -> CPFPN -> one-level dense tokens -> StreamPETRHead."""

    def __init__(self, cfg: StreamPETRViTConfig):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.img_backbone = ViT(cfg.backbone)
        self.img_neck = CPFPN(cfg.neck)
        self.pts_bbox_head = StreamPETRHead(cfg)

    def forward(self, images, lidar2img, state, prev_exists, timestamp,
                ego_pose, ego_pose_inv, train: bool = False,
                generator: Optional[torch.Generator] = None,
                quant_backbone: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        if quant_backbone is not None:
            raise ValueError('StreamPETRViT has no int8 backbone')
        b, n, h, w, _ = images.shape
        if not images.is_floating_point():
            mean = torch.tensor(IMG_MEAN, device=images.device)
            std = torch.tensor(IMG_STD, device=images.device)
            images = (images.float() - mean) / std
        x = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
        feats = self.img_neck(self.img_backbone(x))
        return self.pts_bbox_head(feats, lidar2img, state, prev_exists,
                                  timestamp, ego_pose, ego_pose_inv, train,
                                  generator)
