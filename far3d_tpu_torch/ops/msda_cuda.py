"""Wrapper of the hand-written CUDA MSDA forward kernel (``csrc/msda_fwd.cu``).

Takes the contract of ``ops/msda.py``: value (B, L_total, C) bf16 or f32,
loc (B, Q, P, 2) f32, weights (B, Q, G, L, P) f32, all contiguous on one CUDA
device; returns (B, Q, C) in the value's dtype. Anything else raises. The
kernel launches on torch's current stream, and each launch adds one to
``launch_counts['msda_fwd']``.

The backward (the value and attention gradients of the TPU kernels
``msda_dval_kernel`` and ``msda_dattn_kernel``) belongs to the training slice
of the port and is not written yet: asking for it raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

KERNEL = 'msda_fwd'
_build.launch_counts.setdefault(KERNEL, 0)

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.load_kernel_library(KERNEL)
    fn = lib.msda_fwd
    if fn.argtypes is None:
        fn.argtypes = [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
                       _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                       _c_void_p, _c_int, _c_void_p]
        fn.restype = _c_int
    return lib


def _check(value, spatial_shapes, loc, weights) -> None:
    if not (value.is_cuda and loc.device == value.device
            and weights.device == value.device):
        raise ValueError('msda_fwd: value, loc and weights must lie on one '
                         f'CUDA device, got {value.device}, {loc.device}, '
                         f'{weights.device}')
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'msda_fwd: value must be bf16 or f32, got {value.dtype}')
    if loc.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError('msda_fwd: loc and weights must be f32, got '
                        f'{loc.dtype} and {weights.dtype}')
    if value.dim() != 3 or loc.dim() != 4 or weights.dim() != 5:
        raise ValueError('msda_fwd: expected value (B,L,C), loc (B,Q,P,2), '
                         'weights (B,Q,G,L,P)')
    b, rows, c = value.shape
    bq, q, p, two = loc.shape
    bw, qw, g, n_lvl, pw = weights.shape
    if two != 2 or (bq, bw) != (b, b) or qw != q or pw != p:
        raise ValueError(f'msda_fwd: shapes disagree: value {tuple(value.shape)}'
                         f', loc {tuple(loc.shape)}, weights '
                         f'{tuple(weights.shape)}')
    if n_lvl != len(spatial_shapes) or not 1 <= n_lvl <= 8:
        raise ValueError(f'msda_fwd: {n_lvl} weight levels for '
                         f'{len(spatial_shapes)} spatial shapes (1..8 allowed)')
    if sum(h * w for h, w in spatial_shapes) != rows:
        raise ValueError(f'msda_fwd: spatial shapes {spatial_shapes} do not '
                         f'cover {rows} value rows')
    if c % g or (c // g) % 2 or c // 2 > 1024:
        raise ValueError(f'msda_fwd: channels {c} must split into {g} groups '
                         'of an even width, and C/2 <= 1024')
    for name, t in (('value', value), ('loc', loc), ('weights', weights)):
        if not t.is_contiguous():
            raise ValueError(f'msda_fwd: {name} must be contiguous')
    if value.data_ptr() % (2 * value.element_size()):
        raise ValueError('msda_fwd: value must be aligned to two elements')


def msda_fwd(value: torch.Tensor,
             spatial_shapes: Sequence[Tuple[int, int]],
             loc: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once; see the module docstring for the contract."""
    _check(value, spatial_shapes, loc, weights)
    lib = _library()
    b, rows, c = value.shape
    _, q, p, _ = loc.shape
    g = weights.shape[2]
    out = torch.empty((b, q, c), dtype=value.dtype, device=value.device)
    level_hw = (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(v) for hw in spatial_shapes for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_fwd(value.data_ptr(), loc.data_ptr(), weights.data_ptr(),
                           out.data_ptr(), int(value.dtype == torch.bfloat16),
                           b, q, p, g, c, len(spatial_shapes),
                           ctypes.cast(level_hw, _c_void_p), rows, stream)
    if err != 0:
        raise RuntimeError(f'msda_fwd launch failed: CUDA error {err}')
    _build.launch_counts[KERNEL] += 1
    return out


class _MSDAFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, loc, weights, spatial_shapes):
        return msda_fwd(value, spatial_shapes, loc, weights)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            'the MSDA backward kernels on CUDA belong to the training slice of '
            'the port and are not written yet')


def msda_cuda(value: torch.Tensor,
              spatial_shapes: Sequence[Tuple[int, int]],
              loc: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """MSDA on the card through the kernel, as an autograd node whose
    backward raises."""
    return _MSDAFunction.apply(value, loc, weights,
                               tuple(tuple(s) for s in spatial_shapes))
