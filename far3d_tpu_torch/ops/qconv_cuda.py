"""Wrapper of the hand-written CUDA int8 convolution (``csrc/qconv.cu``).

Takes the contract of ``ops/qconv.py:qconv``: x (n, h, w, ci) int8, w
(co, k, k, ci) int8 with k 1 or 3, a and b (co,) float32, all contiguous on
one CUDA device, stride 1 or 2. Returns (n, ho, wo, co), float32 when
`float_out`, else int8. Anything else raises. One call is one launch on
torch's current stream and adds one to ``launch_counts['qconv']``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .qconv import out_size

NAME = 'qconv'
_build.launch_counts.setdefault(NAME, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, w, a, b, out, n, h, w, ci, co, k, stride, ho, wo, float_out, stream
_ARGTYPES = [_P] * 5 + [_I] * 10 + [_P]


def _entry():
    fn = getattr(_build.load_kernel_library(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def _check(x, w, a, b, stride) -> None:
    want = {'x': (x, torch.int8, 4), 'w': (w, torch.int8, 4),
            'a': (a, torch.float32, 1), 'b': (b, torch.float32, 1)}
    if not (x.is_cuda and all(t.device == x.device
                              for t, _, _ in want.values())):
        raise ValueError(f'{NAME}: x, w, a and b must lie on one CUDA device, '
                         'got ' + ', '.join(str(t.device)
                                            for t, _, _ in want.values()))
    for name, (t, dtype, dim) in want.items():
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f'{NAME}: {name} must be a {dim}-d {dtype}, got '
                            f'{t.dim()}-d {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{NAME}: {name} must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{NAME}: {name} must be aligned to 16 bytes')
    co, k, k2, ci = w.shape
    if k != k2 or k not in (1, 3):
        raise ValueError(f'{NAME}: kernel {k}x{k2}; 1x1 and 3x3 are taken')
    if x.shape[3] != ci:
        raise ValueError(f'{NAME}: x has {x.shape[3]} channels, w {ci}')
    if tuple(a.shape) != (co,) or tuple(b.shape) != (co,):
        raise ValueError(f'{NAME}: a {tuple(a.shape)} and b {tuple(b.shape)} '
                         f'must be ({co},)')
    if stride not in (1, 2):
        raise ValueError(f'{NAME}: stride {stride}; 1 and 2 are taken')
    if max(x.numel(), x.shape[0] * x.shape[1] * x.shape[2] * co) >= 2**31:
        raise ValueError(f'{NAME}: x {tuple(x.shape)} or its output is past '
                         'the int32 index range')


def qconv_cuda(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, stride: int = 1,
               float_out: bool = False) -> torch.Tensor:
    """Launch the kernel once; see the module docstring."""
    _check(x, w, a, b, stride)
    fn = _entry()
    n, h, wd, ci = x.shape
    co, k = w.shape[0], w.shape[1]
    ho, wo = out_size(h, k, stride), out_size(wd, k, stride)
    out = torch.empty((n, ho, wo, co), device=x.device,
                      dtype=torch.float32 if float_out else torch.int8)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), n, h, wd, ci, co, k, stride, ho, wo,
                 int(float_out), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{NAME} launch failed: CUDA error {err}')
    _build.launch_counts[NAME] += 1
    return out
