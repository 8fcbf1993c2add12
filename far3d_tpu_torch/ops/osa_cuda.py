"""Wrapper of the hand-written CUDA fused OSA block (``csrc/osa_fused.cu``).

Takes the contract of ``ops/osa.py:fused_osa``: x_pad (n, rp, cin) bf16 in
the halo-padded row layout, mask (h*wp, 1) bf16, the packed weights (``w1``,
``w2345``, ``wcat`` bf16; ``s5``, ``b5``, ``sc``, ``bc`` f32) and the shape
dictionary, all contiguous on one CUDA device. Returns y_pad (n, rp, cout)
bf16 with zero halo rows and tsum (n, 1, cout) f32. Anything else raises.
One call issues the block's kernels (halo zeroing, five conv stages, the
concat stage, the tsum pass) on torch's current stream and adds one to
``launch_counts['osa_fused']``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .osa import HALO, NUM_CONVS

NAME = 'osa_fused'
TILE_ROWS = 192        # output rows of one thread block (BM in the source)
_build.launch_counts.setdefault(NAME, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, mask, w1, w2345, wcat, s5, b5, sc, bc, scratch, y, partial, tsum,
# n, h, wp, halo, cin, cm, cout, stream
_ARGTYPES = [_P] * 13 + [_I] * 7 + [_P]


def _entry():
    fn = getattr(_build.load_kernel_library(NAME), NAME)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def _check(x_pad, mask, weights, sh) -> None:
    h, w, wp = sh['h'], sh['w'], sh['wp']
    cin, cm, cout = sh['cin'], sh['cm'], sh['cout']
    r = h * wp
    want = {'x_pad': (x_pad, torch.bfloat16, None),
            'mask': (mask, torch.bfloat16, (r, 1)),
            'w1': (weights['w1'], torch.bfloat16, (9 * cin, cm)),
            'w2345': (weights['w2345'], torch.bfloat16,
                      ((NUM_CONVS - 1) * 9 * cm, cm)),
            'wcat': (weights['wcat'], torch.bfloat16,
                     (cin + NUM_CONVS * cm, cout)),
            's5': (weights['s5'], torch.float32, (NUM_CONVS, cm)),
            'b5': (weights['b5'], torch.float32, (NUM_CONVS, cm)),
            'sc': (weights['sc'], torch.float32, (1, cout)),
            'bc': (weights['bc'], torch.float32, (1, cout))}
    if not (x_pad.is_cuda and all(t.device == x_pad.device
                                  for t, _, _ in want.values())):
        raise ValueError(f'{NAME}: ' + ', '.join(want) + ' must lie on one '
                         'CUDA device, got '
                         + ', '.join(str(t.device) for t, _, _ in want.values()))
    if x_pad.dim() != 3 or tuple(x_pad.shape[1:]) != (r + 2 * HALO, cin):
        raise ValueError(f'{NAME}: x_pad {tuple(x_pad.shape)} is not '
                         f'(n, {r + 2 * HALO}, {cin}) for {sh}')
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f'{NAME}: {name} must be {dtype}, got {t.dtype}')
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f'{NAME}: {name} {tuple(t.shape)} is not {shape} '
                             f'for {sh}')
        if not t.is_contiguous():
            raise ValueError(f'{NAME}: {name} must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{NAME}: {name} must be aligned to 16 bytes')
    if wp < w + 1:
        raise ValueError(f'{NAME}: wp {wp} must be at least w + 1 = {w + 1}, '
                         'so that a row ends in a zero pad column')
    if HALO < wp:
        raise ValueError(f'{NAME}: wp {wp} needs a halo of {wp} rows (a tap '
                         f'reaches wp + 1 rows up and down, and the kernel '
                         f'reads a row outside the plane as zeros), the '
                         f'layout has {HALO}')
    if cin % 8 or cm % 8 or cout % 8:
        raise ValueError(f'{NAME}: cin {cin}, cm {cm} and cout {cout} must be '
                         'multiples of 8 (rows of whole 16-byte units)')


def osa_fused(x_pad: torch.Tensor, mask: torch.Tensor,
              weights: Dict[str, torch.Tensor],
              sh: Dict[str, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused block once; see the module docstring."""
    _check(x_pad, mask, weights, sh)
    fn = _entry()
    n, rp, cin = x_pad.shape
    cm, cout = sh['cm'], sh['cout']
    dev = x_pad.device
    tiles = -(-sh['h'] * sh['wp'] // TILE_ROWS)
    scratch = torch.empty((NUM_CONVS, n, rp, cm), dtype=torch.bfloat16,
                          device=dev)
    y_pad = torch.empty((n, rp, cout), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((n, tiles, cout), dtype=torch.float32, device=dev)
    tsum = torch.empty((n, 1, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(x_pad.data_ptr(), mask.data_ptr(), weights['w1'].data_ptr(),
                 weights['w2345'].data_ptr(), weights['wcat'].data_ptr(),
                 weights['s5'].data_ptr(), weights['b5'].data_ptr(),
                 weights['sc'].data_ptr(), weights['bc'].data_ptr(),
                 scratch.data_ptr(), y_pad.data_ptr(), partial.data_ptr(),
                 tsum.data_ptr(), n, sh['h'], sh['wp'], HALO, cin, cm, cout,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{NAME} launch failed: CUDA error {err}')
    _build.launch_counts[NAME] += 1
    return y_pad, tsum
