"""Wrapper of the hand-written CUDA OSA block tail (``csrc/ese_requant.cu``).

Takes the contract of ``ops/quant.py:ese_requant``: y (n, h, w, C) float32
contiguous, gate (n, C) float32 contiguous, r_out a 0-d float32 tensor, and
for an identity block x_id (n, h, w, C) int8 (contiguous or a channel slice
of a wider NHWC buffer) with s_id a 0-d float32 tensor; an optional `out`
(n, h, w, C) int8, contiguous or a channel slice; all on one CUDA device,
C, the pitches and the int8 pointers multiples of 4. Returns `out` (a new
tensor when none is given). Anything else raises. One call is one launch on
torch's current stream and adds one to ``launch_counts['ese_requant']``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .qconv_cuda import pitch_of

NAME = 'ese_requant'
_build.launch_counts.setdefault(NAME, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# y, gate, x_id, xid_pitch, s_id, r_out, out, out_pitch, n, h, w, c, stream
_ARGTYPES = [_P, _P, _P, _I, _P, _P, _P] + [_I] * 5 + [_P]


def _entry():
    fn = getattr(_build.load_kernel_library(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def ese_requant_cuda(y: torch.Tensor, gate: torch.Tensor,
                     r_out: torch.Tensor, x_id: Optional[torch.Tensor] = None,
                     s_id: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel once; see the module docstring."""
    tensors = {'y': y, 'gate': gate, 'r_out': r_out, 'x_id': x_id,
               's_id': s_id, 'out': out}
    given = {k: t for k, t in tensors.items() if t is not None}
    if not (y.is_cuda and all(t.device == y.device for t in given.values())):
        raise ValueError(f'{NAME}: every tensor must lie on one CUDA device, '
                         'got ' + ', '.join(f'{k} {t.device}'
                                            for k, t in given.items()))
    if (x_id is None) != (s_id is None):
        raise ValueError(f'{NAME}: x_id and s_id come together')
    if y.dim() != 4 or y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError(f'{NAME}: y must be a contiguous 4-d float32 NHWC '
                         f'tensor, got {y.dim()}-d {y.dtype}')
    n, h, w, c = y.shape
    if y.numel() >= 2**31:
        raise ValueError(f'{NAME}: y {tuple(y.shape)} is past the int32 '
                         'index range')
    if c % 4:
        raise ValueError(f'{NAME}: {c} channels; a multiple of 4 is taken')
    if (tuple(gate.shape) != (n, c) or gate.dtype != torch.float32
            or not gate.is_contiguous()):
        raise ValueError(f'{NAME}: gate must be a contiguous ({n}, {c}) '
                         f'float32, got {tuple(gate.shape)} {gate.dtype}')
    for k in ('r_out', 's_id'):
        t = tensors[k]
        if t is not None and (t.dim() != 0 or t.dtype != torch.float32):
            raise ValueError(f'{NAME}: {k} must be a 0-d float32 tensor')
    if out is None:
        out = torch.empty((n, h, w, c), device=y.device, dtype=torch.int8)
    pitches = {}
    for k in ('x_id', 'out'):
        t = tensors[k] if k != 'out' else out
        if t is None:
            continue
        if tuple(t.shape) != (n, h, w, c) or t.dtype != torch.int8:
            raise ValueError(f'{NAME}: {k} must be ({n}, {h}, {w}, {c}) '
                             f'int8, got {tuple(t.shape)} {t.dtype}')
        pitches[k] = pitch_of(t, k)
        if pitches[k] % 4 or t.data_ptr() % 4:
            raise ValueError(f'{NAME}: {k} rows must be 4-byte aligned')
    if out.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        err = _entry()(
            y.data_ptr(), gate.data_ptr(),
            x_id.data_ptr() if x_id is not None else None,
            pitches.get('x_id', 0),
            s_id.data_ptr() if s_id is not None else None, r_out.data_ptr(),
            out.data_ptr(), pitches['out'], n, h, w, c,
            torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{NAME} launch failed: CUDA error {err}')
    _build.launch_counts[NAME] += 1
    return out
