"""Wrapper of the hand-written CUDA SwiGLU tail (``csrc/swiglu_tail.cu``).

Takes the contract of ``models/vit.py:swiglu_tail``: ag (..., 2 W) bfloat16
or float32, the ``w12`` product whose halves are the SiLU input and the
gate, each of hid channels padded to W = hid + (-hid % 8), contiguous and
16-byte aligned; weight and bias (hid,) contiguous, 16-byte aligned, of
ag's dtype; all on one CUDA
device, with no autograd to record (the kernel has no backward). Returns a
new (..., W) tensor of ag's dtype: ``ffn_ln(silu(a) * g)`` in the first hid
channels, zeros after. Anything else raises. One call is one launch on
torch's current stream and adds one to ``launch_counts['swiglu_tail']``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

NAME = 'swiglu_tail'
_build.launch_counts.setdefault(NAME, 0)

DTYPES = {torch.bfloat16: 1, torch.float32: 0}
MAX_VECS, MAX_THREADS = 3, 1024        # the kernel's row in registers

_P = ctypes.c_void_p
_I = ctypes.c_int
# ag, weight, bias, out, rows, hid, width, eps, bf16, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P]


def _entry():
    fn = getattr(_build.load_kernel_library(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def check_args(ag: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
               ) -> Tuple[int, int]:
    """Every check of the contract but the device's; (rows, hid)."""
    if ag.dtype not in DTYPES:
        raise ValueError(f'{NAME}: ag must be bfloat16 or float32, got '
                         f'{ag.dtype}')
    for k, t in (('weight', weight), ('bias', bias)):
        if t.dtype != ag.dtype:
            raise ValueError(f'{NAME}: {k} must be {ag.dtype} as ag, got '
                             f'{t.dtype}')
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f'{NAME}: {k} must be a contiguous 1-d tensor, '
                             f'got {tuple(t.shape)} with strides {t.stride()}')
        if t.data_ptr() % 16:
            raise ValueError(f'{NAME}: {k} must be 16-byte aligned')
    hid = weight.shape[0]
    width = hid + -hid % 8
    if bias.shape[0] != hid:
        raise ValueError(f'{NAME}: bias has {bias.shape[0]} channels, '
                         f'weight {hid}')
    if ag.dim() == 0 or ag.shape[-1] != 2 * width:
        raise ValueError(f'{NAME}: ag must be (..., {2 * width}), the two '
                         f'halves of {hid} channels padded to {width}; got '
                         f'{tuple(ag.shape)}')
    if width * ag.element_size() // 16 > MAX_VECS * MAX_THREADS:
        raise ValueError(f'{NAME}: {hid} channels are past the kernel\'s '
                         'row in registers')
    if not ag.is_contiguous():
        raise ValueError(f'{NAME}: ag {tuple(ag.shape)} with strides '
                         f'{ag.stride()} is not contiguous')
    if ag.data_ptr() % 16:
        raise ValueError(f'{NAME}: ag must be 16-byte aligned')
    rows = ag.numel() // ag.shape[-1]
    if rows >= 2**31:
        raise ValueError(f'{NAME}: ag {tuple(ag.shape)} is past the int32 '
                         'range of rows')
    if torch.is_grad_enabled():
        for k, t in (('ag', ag), ('weight', weight), ('bias', bias)):
            if t.requires_grad:
                raise ValueError(f'{NAME}: {k} requires grad, and the kernel '
                                 'has no backward')
    return rows, hid


def swiglu_tail_cuda(ag: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel once; see the module docstring."""
    given = {'ag': ag, 'weight': weight, 'bias': bias}
    if not (ag.is_cuda and all(t.device == ag.device
                               for t in given.values())):
        raise ValueError(f'{NAME}: every tensor must lie on one CUDA device, '
                         'got ' + ', '.join(f'{k} {t.device}'
                                            for k, t in given.items()))
    rows, hid = check_args(ag, weight, bias)
    width = ag.shape[-1] // 2
    out = torch.empty((*ag.shape[:-1], width), device=ag.device,
                      dtype=ag.dtype)
    if rows == 0:
        return out
    with torch.cuda.device(ag.device):
        err = _entry()(
            ag.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), rows, hid, width, eps, DTYPES[ag.dtype],
            torch.cuda.current_stream(ag.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{NAME} launch failed: CUDA error {err}')
    _build.launch_counts[NAME] += 1
    return out
