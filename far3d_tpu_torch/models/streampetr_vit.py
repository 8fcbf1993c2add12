"""StreamPETR with the EVA-02 ViT backbone (exiawsh/StreamPETR, its ViT-L
entries; the nuScenes test entry runs 800x1600 images).

The model is ``StreamPETR`` with the image side swapped: the ViT of
``models/vit.py`` under ``img_backbone`` and a single-input CPFPN under
``img_neck``, which gives the stride-16 map the head reads. Everything after
the neck (``StreamPETRHead``, the memory, the decode, the streaming step of
``train/petr_step.py`` and its CUDA graphs) is the VoVNet model's. There is
no int8 path for the ViT (``ops/quant.py:quantize_petr_backbone`` refuses
it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.spans import span
from .streampetr import StreamPETR, StreamPETRConfig, StreamPETRHead, \
    normalized
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
    """A 1x1 lateral conv then a 3x3 output conv, both with bias and with no
    norm or activation (mmdet FPN's convs, the names of ``models/vovnet.py``'s
    FPN)."""

    def __init__(self, cfg: CPFPNConfig):
        super().__init__()
        oc = cfg.out_channels
        self.lateral_convs = nn.ModuleList(
            [_ConvModule(cfg.in_channels, oc, 1)])
        self.fpn_convs = nn.ModuleList([_ConvModule(oc, oc, 3, padding=1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fpn_convs[0](self.lateral_convs[0](x))


class StreamPETRViT(StreamPETR):
    """ViT -> CPFPN -> one-level dense tokens -> StreamPETRHead."""

    def __init__(self, cfg: StreamPETRViTConfig):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.img_backbone = ViT(cfg.backbone)
        self.img_neck = CPFPN(cfg.neck)
        self.pts_bbox_head = StreamPETRHead(cfg)

    def forward_towers(self, images: torch.Tensor,
                       quant_backbone: Optional[Dict[str, Any]] = None
                       ) -> torch.Tensor:
        """(B, N, H, W, 3) images normalized, the ViT and the neck ->
        (B * N, C, H / 16, W / 16)."""
        if quant_backbone is not None:
            raise ValueError('StreamPETRViT has no int8 backbone')
        b, n, h, w, _ = images.shape
        with span('model.backbone'):
            x = normalized(images).reshape(b * n, h, w, 3)
            x = self.img_backbone(x.permute(0, 3, 1, 2))
        with span('model.neck'):
            return self.img_neck(x)


def random_vit_petr_state_dict(cfg: StreamPETRViTConfig, seed: int = 0
                               ) -> Dict[str, torch.Tensor]:
    """Seeded random weights, fan-in scaled as
    ``utils/convert.py:random_petr_state_dict``'s, in the state dict's
    order."""
    from ..utils.convert import _random_weights
    with torch.device('meta'):
        sd = StreamPETRViT(cfg).state_dict()
    return _random_weights({k: tuple(v.shape) for k, v in sd.items()},
                           np.random.default_rng(seed))


def tiny_vit_petr_config() -> StreamPETRViTConfig:
    """Scaled-down config for CPU tests: ``tiny_petr_config``'s head, a
    3-block ViT 64 wide (two windowed blocks, then a global one) with
    4 x 4 windows, so the 4 x 6 patch grid of a 64 x 96 image is padded
    to 4 x 8."""
    from .streampetr import tiny_petr_config
    head = {f.name: getattr(tiny_petr_config(), f.name)
            for f in dataclasses.fields(StreamPETRConfig)
            if f.name not in ('backbone', 'neck')}
    return StreamPETRViTConfig(
        **head,
        backbone=ViTConfig(embed_dim=64, depth=3, num_heads=4,
                           mlp_hidden_dim=170, window_size=4,
                           global_blocks=(2,)),
        neck=CPFPNConfig(in_channels=64, out_channels=64))
