"""Shared building blocks (counterpart of ``far3d_tpu/models/layers.py``).

Every layer here computes in the dtype of its input, as the flax layers of the
JAX package do (``dtype=x.dtype``): the parameters stay f32 and are cast at
the call. So bf16 images keep the backbone, FPN and 2D head in bf16, while the
f32 query-side tensors of the head stay f32.

Parameter names follow the reference checkpoint's keys, so a reference
``state_dict`` loads with ``load_state_dict``.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(lower(x), lower(self.weight.to(x.dtype)), bias)


# The benchmark's control: inside ``one_step_lower`` every convolution's and
# linear layer's input and weight are rounded one precision below their
# dtype (float8 e4m3 at a per-tensor scale for bf16 or f16, bf16 for f32).
LOWER = False


@contextlib.contextmanager
def one_step_lower():
    global LOWER
    old, LOWER = LOWER, True
    try:
        yield
    finally:
        LOWER = old


def lower(x: torch.Tensor) -> torch.Tensor:
    """x rounded one precision below its dtype, the gradient passed straight
    through; x itself outside ``one_step_lower``."""
    if not LOWER:
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        scale = 448.0 / x.detach().abs().amax().float().clamp_min(1e-12)
        q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    else:
        q = x.detach().to(torch.bfloat16)
    return x + (q.to(x.dtype) - x).detach()


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(lower(x), lower(self.weight.to(x.dtype)),
                                  bias)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computing in the input's dtype."""

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in the input's dtype (flax's
    ``LayerNorm(dtype=x.dtype)``)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always normalizes with its stored running statistics
    (the reference runs the backbone BN with norm_eval=True). The scale and
    shift are folded in f32 and applied in the input's dtype
    (layers.py:15-37)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        shape = (1, -1, 1, 1)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class BatchNorm(FrozenBatchNorm):
    """BatchNorm with flax.linen.BatchNorm's semantics, for the YOLOX towers
    (heads2d.py:34-35: momentum 0.97, eps 1e-3). At inference it is the
    frozen affine of ``FrozenBatchNorm``. In training it normalizes with the
    batch's statistics over (N, H, W), reduced in f32 with the biased
    variance, computes in f32 and returns the input's dtype, and updates the
    running statistics in place: new = momentum * old + (1 - momentum) *
    batch, with the biased batch variance (``nn.BatchNorm2d`` uses the
    unbiased one).

    Under data parallelism across two or more ranks (``parallel/mesh.py``)
    the statistics are the global batch's, as under the JAX package's mesh,
    whose GSPMD computes them on the global array: the count and the sum of
    x give the mean, then the sum of (x - mean)^2 the biased variance, each
    summed over the ranks by a differentiable all-reduce."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.97):
        super().__init__(features, eps)
        self.momentum = momentum

    def forward(self, x, train: bool = False):
        if not train:
            return super().forward(x)
        xf = x.float()
        if mesh.rank_and_world()[1] == 1:
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = _global_stats(xf)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(
                (1 - self.momentum) * mean.detach())
            self.running_var.mul_(self.momentum).add_(
                (1 - self.momentum) * var.detach())
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * (torch.rsqrt(var + self.eps)
                                       * self.weight).view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


def _global_stats(xf: torch.Tensor):
    """(mean, biased variance) per channel of the NCHW `xf` over every
    rank's (N, H, W), in two passes of a differentiable all-reduce."""
    c = xf.shape[1]
    s = mesh.all_reduce_sum(torch.cat([
        xf.sum(dim=(0, 2, 3)), xf.new_full((1,), xf.numel() // c)]))
    count = s[c:].detach()
    mean = s[:c] / count
    sq = mesh.all_reduce_sum(
        (xf - mean.view(1, -1, 1, 1)).square().sum(dim=(0, 2, 3)))
    return mean, sq / count


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax.linen.Dropout: identity unless training with rate > 0; then each
    element is kept with probability 1 - rate, drawn from `generator` (which
    must lie on x's device), and scaled by 1 / (1 - rate)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in training needs a torch.Generator')
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ConvBNReLU(nn.Sequential):
    """conv (symmetric (k-1)//2 padding, no bias) -> frozen BN -> ReLU, the
    reference VoVNet's conv3x3/conv1x1 block (layers.py:40-62).

    The reference names the parts ``<prefix>/conv`` and ``<prefix>/norm``
    inside its parent; so does this block. Use ``chain`` to put several blocks
    into one flat parent, as the reference stem does."""

    def __init__(self, prefix: str, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1):
        p = (kernel - 1) // 2
        super().__init__(OrderedDict([
            (f'{prefix}/conv', Conv2d(in_ch, out_ch, kernel, stride=stride,
                                      padding=p, bias=False)),
            (f'{prefix}/norm', FrozenBatchNorm(out_ch)),
            (f'{prefix}/relu', nn.ReLU(inplace=True)),
        ]))

    @staticmethod
    def chain(blocks: Sequence['ConvBNReLU']) -> nn.Sequential:
        return nn.Sequential(OrderedDict(
            item for blk in blocks for item in blk.named_children()))


class GroupNormConv(nn.Sequential):
    """conv 3x3 (bias) -> GroupNorm(32) -> ReLU (depth_predictor.py:41-44);
    children 0, 1, 2 as in the reference's depth head."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 groups: int = 32):
        super().__init__(
            Conv2d(in_ch, out_ch, kernel, padding=(kernel - 1) // 2),
            GroupNorm(groups, out_ch, eps=1e-5),
            nn.ReLU(inplace=True))


class MLN(nn.Module):
    """Meta LayerNorm (misc.py:153-190): gamma and beta predicted from a
    conditioning code."""

    def __init__(self, c_dim: int, f_dim: int = 256, use_ln: bool = True):
        super().__init__()
        self.use_ln = use_ln
        self.reduce = nn.Sequential(Linear(c_dim, f_dim), nn.ReLU())
        self.gamma = Linear(f_dim, f_dim)
        self.beta = Linear(f_dim, f_dim)

    def forward(self, x, c):
        if self.use_ln:
            x = F.layer_norm(x, (x.shape[-1],), eps=1e-5)
        h = self.reduce(c.to(x.dtype))
        return self.gamma(h) * x + self.beta(h)


class SELayerLinear(nn.Module):
    """Linear squeeze-excite gate (misc.py:138-150)."""

    def __init__(self, channels: int):
        super().__init__()
        self.reduce = Linear(channels, channels)
        self.expand = Linear(channels, channels)

    def forward(self, x, x_se):
        h = self.expand(F.relu(self.reduce(x_se)))
        return x * torch.sigmoid(h)


def MLP(features: Sequence[int], in_dim: int) -> nn.Sequential:
    """Linear stack with ReLU between layers; children 0, 2, ... are the
    linears, as in the reference's ``query_embedding`` (farhead.py:268-272)."""
    layers = []
    for i, f in enumerate(features):
        layers.append(Linear(in_dim, f))
        if i < len(features) - 1:
            layers.append(nn.ReLU())
        in_dim = f
    return nn.Sequential(*layers)


class FFN(nn.Module):
    """Transformer FFN with residual (mmcv FFN); ``layers.0.0`` and
    ``layers.1`` are the two linears, as in the reference. In training a
    dropout follows the ReLU and the second linear (layers.py:139-141)."""

    def __init__(self, embed_dims: int = 256, ffn_dims: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dims, ffn_dims), nn.ReLU()),
            Linear(ffn_dims, embed_dims))

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h = dropout(self.layers[0](x), self.dropout, train, generator)
        h = dropout(self.layers[1](h), self.dropout, train, generator)
        return x + h
