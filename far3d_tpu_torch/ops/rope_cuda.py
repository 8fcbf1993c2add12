"""Wrapper of the hand-written CUDA rotation of the ViT's q and k
(``csrc/vit_rope.cu``).

Takes the contract of ``models/vit.py:rope``: x (G, B, H, S, D) bfloat16 or
float32, in the cell the view ``qkv[:2]`` of the ``qkv`` product (any
strides, the last dim's 1, each a multiple of 16 bytes), with D a multiple
of 8; cos and sin (S, D) contiguous, of x's dtype (``rope_tables``); the
three 16-byte aligned, on one CUDA device, with no autograd to record (the
kernel has no backward). Returns a new tensor of x's shape and dtype, dense
with its dims in the order (B, S, G, H, D): the layout the PyTorch passes
give the ``qkv`` view (``out_like``), so the attention reads the same
strides. Anything else raises. One call is one launch on torch's current
stream and adds one to ``launch_counts['vit_rope']``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

NAME = 'vit_rope'
_build.launch_counts.setdefault(NAME, 0)

DTYPES = {torch.bfloat16: 1, torch.float32: 0}
MAX_VECTORS = 2 ** 30                  # the kernel's int32 vector index

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# x, cos, sin, out, tokens, dv, heads, groups, seq, 4 strides, bf16, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _I, _P]


def _entry():
    fn = getattr(_build.load_kernel_library(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def out_like(x: torch.Tensor) -> torch.Tensor:
    """An empty (G, B, H, S, D) tensor like x, dense in the order (B, S, G,
    H, D)."""
    g, b, h, s, d = x.shape
    return torch.empty((b, s, g, h, d), device=x.device,
                       dtype=x.dtype).permute(2, 0, 3, 1, 4)


def check_args(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> Tuple[int, int]:
    """Every check of the contract but the device's; (vectors, vectors a
    head row)."""
    if x.dtype not in DTYPES:
        raise ValueError(f'{NAME}: x must be bfloat16 or float32, got '
                         f'{x.dtype}')
    if x.dim() != 5:
        raise ValueError(f'{NAME}: x must be (G, B, H, S, D), got '
                         f'{tuple(x.shape)}')
    s, d = x.shape[-2:]
    if d % 8:
        raise ValueError(f'{NAME}: the head width D = {d} must be a multiple '
                         'of 8')
    if x.stride(-1) != 1:
        raise ValueError(f'{NAME}: x {tuple(x.shape)} with strides '
                         f'{x.stride()} has a last-dim stride other than 1')
    if x.data_ptr() % 16:
        raise ValueError(f'{NAME}: x must be 16-byte aligned')
    if any(st * x.element_size() % 16 for st in x.stride()[:-1]):
        raise ValueError(f'{NAME}: the rows of x {tuple(x.shape)} with '
                         f'strides {x.stride()} are not 16-byte aligned')
    for k, t in (('cos', cos), ('sin', sin)):
        if t.dtype != x.dtype:
            raise ValueError(f'{NAME}: {k} must be {x.dtype} as x, got '
                             f'{t.dtype}')
        if tuple(t.shape) != (s, d):
            raise ValueError(f'{NAME}: {k} must be (S, D) = {(s, d)}, got '
                             f'{tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{NAME}: {k} with strides {t.stride()} is not '
                             'contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{NAME}: {k} must be 16-byte aligned')
    dv = d * x.element_size() // 16
    total = x.numel() * x.element_size() // 16
    if total >= MAX_VECTORS:
        raise ValueError(f'{NAME}: x {tuple(x.shape)} is past the kernel\'s '
                         'int32 range of vectors')
    if torch.is_grad_enabled():
        for k, t in (('x', x), ('cos', cos), ('sin', sin)):
            if t.requires_grad:
                raise ValueError(f'{NAME}: {k} requires grad, and the kernel '
                                 'has no backward')
    return total, dv


def rope_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
              ) -> torch.Tensor:
    """Launch the kernel once; see the module docstring."""
    given = {'x': x, 'cos': cos, 'sin': sin}
    if not (x.is_cuda and all(t.device == x.device for t in given.values())):
        raise ValueError(f'{NAME}: every tensor must lie on one CUDA device, '
                         'got ' + ', '.join(f'{k} {t.device}'
                                            for k, t in given.items()))
    total, dv = check_args(x, cos, sin)
    out = out_like(x)
    if total == 0:
        return out
    g, b, h, s, _ = x.shape
    with torch.cuda.device(x.device):
        err = _entry()(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            b * s, dv, h, g, s, *x.stride()[:4], DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{NAME} launch failed: CUDA error {err}')
    _build.launch_counts[NAME] += 1
    return out
