"""int8 convolution with a requantising epilogue, the runtime of the int8
backbone (counterpart of ``_qconv`` in ``far3d_tpu/ops/quant.py``, which XLA
computes as an s8 convolution with an s32 result and a fused float epilogue).

Contract, layouts as the kernel reads them:

  x      (n, h, w, ci)   int8, NHWC: contiguous, or a channel slice
                         ``buf[..., c0:c0 + ci]`` of a wider NHWC buffer
                         (pixels ``buf.shape[-1]`` bytes apart)
  w      (co, k, k, ci)  int8, k in {1, 3}, SAME padding (k - 1) // 2
  a, b   (co,)           float32 per-output-channel multipliers
  stride 1 or 2
  -> (n, ho, wo, co): ``relu(float(acc) * a + b)`` in float32 when
     `float_out`, else ``clip(round(that), 0, 127)`` in int8, where acc is
     the exact int32 sum; the product and the sum are each rounded (no fused
     multiply-add) and round is half to even. Written into `out` when given
     (a contiguous tensor or a channel slice of a wider buffer, as x), else
     into a new tensor. With `channel_sums` (float output only) also the
     per-channel sums of the result over each image, (n, co) float32, the
     eSE gate's mean times h*w; the plain version sums with ``Tensor.sum``,
     the kernel in a fixed order of its own.

``qconv`` sends a CPU tensor to the plain version ``qconv_reference`` and a
CUDA tensor to the hand-written kernel (``ops/qconv_cuda.py``,
``csrc/qconv.cu``), which launches or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def out_size(size: int, k: int, stride: int) -> int:
    """Output extent of a SAME-padded (p = (k - 1) // 2 on both sides) conv."""
    return (size + 2 * ((k - 1) // 2) - k) // stride + 1


def qconv_acc_reference(x: torch.Tensor, w: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """The exact int32 accumulator (n, ho, wo, co): ``F.unfold`` in float64,
    which holds these sums exactly (each is below 2^53), times the
    weights."""
    n, h, wd, ci = x.shape
    co, k = w.shape[0], w.shape[1]
    cols = F.unfold(x.permute(0, 3, 1, 2).double(), k,
                    padding=(k - 1) // 2, stride=stride)    # (n, ci*k*k, L)
    wm = w.permute(0, 3, 1, 2).reshape(co, ci * k * k).double()
    acc = (wm @ cols).round().to(torch.int32)               # (n, co, L)
    ho, wo = out_size(h, k, stride), out_size(wd, k, stride)
    return acc.reshape(n, co, ho, wo).permute(0, 2, 3, 1).contiguous()


def requant_epilogue(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     float_out: bool) -> torch.Tensor:
    """``relu(float(acc) * a + b)``, then, unless `float_out`, rounded half
    to even and clipped to [0, 127] as int8."""
    y = torch.relu(acc.float() * a + b)
    if float_out:
        return y
    return torch.round(y).clamp_(0, 127).to(torch.int8)


def qconv_reference(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, stride: int = 1, float_out: bool = False,
                    out: Optional[torch.Tensor] = None,
                    channel_sums: bool = False):
    """Plain version of the kernel, same arguments and result as ``qconv``."""
    if channel_sums and not float_out:
        raise ValueError('channel_sums needs the float output')
    y = requant_epilogue(qconv_acc_reference(x, w, stride), a, b, float_out)
    sums = y.sum(dim=(1, 2)) if channel_sums else None
    if out is not None:
        y = out.copy_(y)
    return (y, sums) if channel_sums else y


def qconv(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          stride: int = 1, float_out: bool = False,
          out: Optional[torch.Tensor] = None, channel_sums: bool = False):
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA one.
    Returns the output, or (output, sums) with `channel_sums`."""
    if x.is_cuda:
        from .qconv_cuda import qconv_cuda
        return qconv_cuda(x, w, a, b, stride, float_out, out, channel_sums)
    return qconv_reference(x, w, a, b, stride, float_out, out, channel_sums)
