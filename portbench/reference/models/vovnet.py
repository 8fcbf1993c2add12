"""VoVNet-99-eSE backbone and FPN neck (counterpart of
``far3d_tpu/models/vovnet.py``).

Tensors here are NCHW in shape. The detector hands in its images as a
permuted NHWC tensor, so on the card they are channels_last in memory, which
cuDNN's bf16 convolutions prefer; convolutions keep that layout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BackboneConfig, NeckConfig
from .layers import Conv2d, ConvBNReLU


class eSEModule(nn.Module):
    """Effective squeeze-excite with a hard-sigmoid gate (vovnet.py:173-185)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1)

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * ((s + 3.0).clamp(0.0, 6.0) / 6.0)


class OSAModule(nn.Module):
    """One-shot aggregation block (vovnet.py:188-238): `layers_per_block`
    successive 3x3 convs, concat of the input and every intermediate, 1x1
    fuse, eSE gate, identity residual on all but a stage's first block."""

    def __init__(self, in_ch: int, stage_ch: int, concat_ch: int,
                 layers_per_block: int, name: str, identity: bool = False):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList()
        ch = in_ch
        for i in range(layers_per_block):
            self.layers.append(ConvBNReLU(f'{name}_{i}', ch, stage_ch))
            ch = stage_ch
        self.concat = ConvBNReLU(f'{name}_concat',
                                 in_ch + layers_per_block * stage_ch,
                                 concat_ch, kernel=1)
        self.ese = eSEModule(concat_ch)

    def forward(self, x):
        identity_feat = x
        outputs = [x]
        for layer in self.layers:
            x = layer(x)
            outputs.append(x)
        x = self.ese(self.concat(torch.cat(outputs, dim=1)))
        return x + identity_feat if self.identity else x


class VoVNet(nn.Module):
    """VoVNet backbone; input (BN, 3, H, W), returns the configured stage
    outputs at strides 4/8/16/32. Child names follow the reference
    (``stem``, ``stage2`` .. ``stage5``, ``OSA{s}_{b}``)."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.cfg = cfg
        sc = cfg.stem_channels
        self.stem = ConvBNReLU.chain([
            ConvBNReLU('stem_1', 3, sc[0], stride=2),
            ConvBNReLU('stem_2', sc[0], sc[1], stride=1),
            ConvBNReLU('stem_3', sc[1], sc[2], stride=2)])
        in_ch = sc[2]
        self.stage_names = []
        for si in range(4):
            s = si + 2
            stage = nn.Sequential()
            for bi in range(cfg.blocks_per_stage[si]):
                stage.add_module(f'OSA{s}_{bi + 1}', OSAModule(
                    in_ch, cfg.stage_conv_channels[si],
                    cfg.stage_out_channels[si], cfg.layers_per_block,
                    name=f'OSA{s}_{bi + 1}', identity=bi > 0))
                in_ch = cfg.stage_out_channels[si]
            self.add_module(f'stage{s}', stage)
            self.stage_names.append(f'stage{s}')

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x)
        outputs = []
        for si, name in enumerate(self.stage_names):
            if si > 0:   # stages 3..5 downsample first (vovnet.py:249)
                x = F.max_pool2d(x, 3, stride=2, ceil_mode=True)
            x = getattr(self, name)(x)
            if si + 2 in self.cfg.out_stages:
                outputs.append(x)
        return outputs


class _ConvModule(nn.Module):
    """A bare conv under the name ``conv`` (mmcv ConvModule without norm)."""

    def __init__(self, *args, **kw):
        super().__init__()
        self.conv = Conv2d(*args, **kw)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    """mmdet FPN (far3d.py:50-57): start_level=1, 4 outs, nearest top-down
    upsampling, extra stride-2 convs on the last output."""

    def __init__(self, cfg: NeckConfig):
        super().__init__()
        self.cfg = cfg
        used = cfg.in_channels[cfg.start_level:]
        oc = cfg.out_channels
        self.lateral_convs = nn.ModuleList(
            [_ConvModule(c, oc, 1) for c in used])
        self.fpn_convs = nn.ModuleList(
            [_ConvModule(oc, oc, 3, padding=1) for _ in used]
            + [_ConvModule(oc, oc, 3, stride=2, padding=1)
               for _ in range(len(used), cfg.num_outs)])

    def forward(self, inputs: Sequence[torch.Tensor],
                level: Optional[int] = None):
        """The num_outs outputs; with `level` (below the number of inputs
        used) only that output, from the laterals its top-down sum reads and
        its own 3x3 conv."""
        c = self.cfg
        used = list(inputs[c.start_level:])
        n_used = len(used)
        first = 0 if level is None else level
        if not 0 <= first < n_used:
            raise ValueError(f'FPN level {level} of {n_used} inputs used')
        laterals = [None] * first + [
            conv(x) for conv, x in zip(self.lateral_convs[first:],
                                       used[first:])]
        for i in range(n_used - 1, first, -1):
            h, w = laterals[i - 1].shape[-2:]
            up = F.interpolate(laterals[i], scale_factor=2, mode='nearest')
            laterals[i - 1] = laterals[i - 1] + up[..., :h, :w]
        if level is not None:
            return self.fpn_convs[level](laterals[level])
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n_used)]
        src = outs[-1]
        for i in range(n_used, c.num_outs):
            if i > n_used and c.relu_before_extra_convs:
                src = F.relu(src)
            src = self.fpn_convs[i](src)
            outs.append(src)
        return outs
