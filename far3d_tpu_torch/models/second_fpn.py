"""CustomSECONDFPN neck variant (the twin of ``far3d_tpu/models/
second_fpn.py``; reference models/necks/second_fpn.py:12-111).

SECOND-style neck: per-level transposed-conv upsample (or strided-conv
downsample) to a common resolution, frozen BN (eps 1e-3), ReLU and a
channel concat, with an optional final conv bottleneck. No model of the
repo calls it; it is here for model-family parity. Its parameters follow
the reference's layout (``deblocks.{i}`` = conv, BN, ReLU;
``final_conv`` = 3x3 conv, BN, ReLU, 1x1 conv), and
``utils/convert.py:second_fpn_from_jax_variables`` carries the JAX
module's variables across.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .layers import FrozenBatchNorm


class SECONDFPN(nn.Module):
    """in_channels: per-level inputs; out_channels: per-level outputs.

    upsample_strides s: s > 1 -> ConvTranspose(kernel=s, stride=s); s == 1
    without use_conv_for_no_stride -> kernel-1 deconv (== 1x1 conv); s < 1
    -> strided conv with kernel = stride = round(1/s). Inputs and outputs
    are NCHW."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 768, 1024),
                 out_channels: Sequence[int] = (128, 128, 128, 128),
                 upsample_strides: Sequence[float] = (1, 2, 4, 8),
                 use_conv_for_no_stride: bool = False,
                 final_conv_feature_dim: Optional[int] = None):
        super().__init__()
        deblocks = []
        for ci, oc, s in zip(in_channels, out_channels, upsample_strides):
            if s > 1 or (s == 1 and not use_conv_for_no_stride):
                st = int(s)
                up = nn.ConvTranspose2d(ci, oc, st, stride=st, bias=False)
            else:
                st = int(round(1 / s))
                up = nn.Conv2d(ci, oc, st, stride=st, bias=False)
            deblocks.append(nn.Sequential(up, FrozenBatchNorm(oc, eps=1e-3),
                                          nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)
        self.final_conv = None
        if final_conv_feature_dim is not None:
            half = sum(out_channels) // 2
            self.final_conv = nn.Sequential(
                nn.Conv2d(sum(out_channels), half, 3, padding=1, bias=False),
                FrozenBatchNorm(half, eps=1e-3), nn.ReLU(),
                nn.Conv2d(half, final_conv_feature_dim, 1, bias=False))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = torch.cat([block(x) for block, x in zip(self.deblocks, inputs)],
                        dim=1)
        if self.final_conv is not None:
            out = self.final_conv(out)
        return [out]
