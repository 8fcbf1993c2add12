"""Wrappers of the hand-written CUDA MSDA kernels: the forward
(``csrc/msda_fwd.cu``) and the two backward kernels (``csrc/msda_bwd.cu``).

Takes the contract of ``ops/msda.py``: value (B, L_total, C) bf16 or f32,
loc (B, Q, P, 2) f32, weights (B, Q, G, L, P) f32, and for the backward
grad_out (B, Q, C) in the value's dtype, all contiguous on one CUDA device.
The forward returns (B, Q, C) in the value's dtype; ``msda_dval`` returns
d_value in the value's dtype, ``msda_dattn`` returns d_loc and d_weights in
f32. Anything else raises. The kernels launch on torch's current stream, and
each wrapper adds one to its ``launch_counts`` entry per call.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

FWD, DVAL, DATTN = 'msda_fwd', 'msda_dval', 'msda_dattn'
for _name in (FWD, DVAL, DATTN):
    _build.launch_counts.setdefault(_name, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # value, loc, weights, out, is_bf16, b, q, p, g, c, levels, level_hw,
    # rows, stream
    FWD: [_P, _P, _P, _P] + [_I] * 7 + [_P, _I, _P],
    # grad_out, loc, weights, d_value, scratch, is_bf16, b, q, p, g, c,
    # levels, level_hw, rows, stream
    DVAL: [_P] * 5 + [_I] * 7 + [_P, _I, _P],
    # value, grad_out, loc, weights, d_loc, d_weights, is_bf16, vec, b, q, p,
    # g, c, levels, level_hw, rows, stream
    DATTN: [_P] * 6 + [_I] * 8 + [_P, _I, _P],
}


def _entry(source: str, name: str):
    fn = getattr(_build.load_kernel_library(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn


def build() -> None:
    """Builds (if needed) and loads both libraries, their two nvcc runs
    started together; a failed build of either raises."""
    _build.load_kernel_libraries('msda_fwd', 'msda_bwd')
    for source, name in (('msda_fwd', FWD), ('msda_bwd', DVAL),
                         ('msda_bwd', DATTN)):
        _entry(source, name)


def _check(name, value, spatial_shapes, loc, weights, grad_out=None) -> None:
    tensors = [('value', value), ('loc', loc), ('weights', weights)]
    if grad_out is not None:
        tensors.append(('grad_out', grad_out))
    if not (value.is_cuda and all(t.device == value.device
                                  for _, t in tensors)):
        raise ValueError(f'{name}: ' + ', '.join(n for n, _ in tensors)
                         + ' must lie on one CUDA device, got '
                         + ', '.join(str(t.device) for _, t in tensors))
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{name}: value must be bf16 or f32, got {value.dtype}')
    if loc.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f'{name}: loc and weights must be f32, got '
                        f'{loc.dtype} and {weights.dtype}')
    if value.dim() != 3 or loc.dim() != 4 or weights.dim() != 5:
        raise ValueError(f'{name}: expected value (B,L,C), loc (B,Q,P,2), '
                         'weights (B,Q,G,L,P)')
    b, rows, c = value.shape
    bq, q, p, two = loc.shape
    bw, qw, g, n_lvl, pw = weights.shape
    if two != 2 or (bq, bw) != (b, b) or qw != q or pw != p:
        raise ValueError(f'{name}: shapes disagree: value '
                         f'{tuple(value.shape)}, loc {tuple(loc.shape)}, '
                         f'weights {tuple(weights.shape)}')
    if grad_out is not None:
        if grad_out.dtype != value.dtype:
            raise TypeError(f'{name}: grad_out must have the value dtype '
                            f'{value.dtype}, got {grad_out.dtype}')
        if tuple(grad_out.shape) != (b, q, c):
            raise ValueError(f'{name}: grad_out {tuple(grad_out.shape)} is '
                             f'not {(b, q, c)}')
    if n_lvl != len(spatial_shapes) or not 1 <= n_lvl <= 8:
        raise ValueError(f'{name}: {n_lvl} weight levels for '
                         f'{len(spatial_shapes)} spatial shapes (1..8 allowed)')
    if sum(h * w for h, w in spatial_shapes) != rows:
        raise ValueError(f'{name}: spatial shapes {spatial_shapes} do not '
                         f'cover {rows} value rows')
    if c % g or (c // g) % 2 or c // 2 > 1024:
        raise ValueError(f'{name}: channels {c} must split into {g} groups '
                         'of an even width, and C/2 <= 1024')
    for n, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f'{name}: {n} must be contiguous')
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f'{name}: {n} must be aligned to two elements')


def _level_hw(spatial_shapes):
    return ctypes.cast((ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(v) for hw in spatial_shapes for v in hw]), _P)


def _launch(name, fn, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')
    _build.launch_counts[name] += 1


def msda_fwd(value: torch.Tensor,
             spatial_shapes: Sequence[Tuple[int, int]],
             loc: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel once; see the module docstring."""
    _check(FWD, value, spatial_shapes, loc, weights)
    fn = _entry('msda_fwd', FWD)
    b, rows, c = value.shape
    _, q, p, _ = loc.shape
    g = weights.shape[2]
    out = torch.empty((b, q, c), dtype=value.dtype, device=value.device)
    _launch(FWD, fn, value.device, value.data_ptr(), loc.data_ptr(),
            weights.data_ptr(), out.data_ptr(),
            int(value.dtype == torch.bfloat16), b, q, p, g, c,
            len(spatial_shapes), _level_hw(spatial_shapes), rows)
    return out


def msda_dval(value: torch.Tensor,
              spatial_shapes: Sequence[Tuple[int, int]],
              loc: torch.Tensor,
              weights: torch.Tensor,
              grad_out: torch.Tensor) -> torch.Tensor:
    """d_value in the value's dtype (only its shape and dtype are read from
    `value`): a scatter-add into a zeroed f32 scratch, cast once."""
    _check(DVAL, value, spatial_shapes, loc, weights, grad_out)
    fn = _entry('msda_bwd', DVAL)
    b, rows, c = value.shape
    _, q, p, _ = loc.shape
    g = weights.shape[2]
    d_value = torch.empty_like(value)
    scratch = d_value if value.dtype == torch.float32 else torch.empty(
        value.shape, dtype=torch.float32, device=value.device)
    _launch(DVAL, fn, value.device, grad_out.data_ptr(), loc.data_ptr(),
            weights.data_ptr(), d_value.data_ptr(), scratch.data_ptr(),
            int(value.dtype == torch.bfloat16), b, q, p, g, c,
            len(spatial_shapes), _level_hw(spatial_shapes), rows)
    return d_value


def _lane_width(c: int, g: int) -> int:
    """Channels a lane of msda_dattn owns: the smallest of 2, 4, 8, 16 that
    fits C into one warp with each group a power-of-two run of lanes."""
    for vec in (2, 4, 8, 16):
        lanes = (c // g) // vec
        if (c % vec == 0 and c // vec <= 32 and (c // g) % vec == 0
                and lanes & (lanes - 1) == 0):
            return vec
    raise ValueError(f'msda_dattn: {c} channels in {g} groups do not fit one '
                     'warp (C <= 512, each group a power-of-two run of lanes)')


def msda_dattn(value: torch.Tensor,
               spatial_shapes: Sequence[Tuple[int, int]],
               loc: torch.Tensor,
               weights: torch.Tensor,
               grad_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_loc (B, Q, P, 2) f32, d_weights (B, Q, G, L, P) f32)."""
    _check(DATTN, value, spatial_shapes, loc, weights, grad_out)
    b, rows, c = value.shape
    _, q, p, _ = loc.shape
    g = weights.shape[2]
    vec = _lane_width(c, g)
    fn = _entry('msda_bwd', DATTN)
    d_loc = torch.empty(loc.shape, dtype=torch.float32, device=value.device)
    d_weights = torch.empty(weights.shape, dtype=torch.float32,
                            device=value.device)
    _launch(DATTN, fn, value.device, value.data_ptr(), grad_out.data_ptr(),
            loc.data_ptr(), weights.data_ptr(), d_loc.data_ptr(),
            d_weights.data_ptr(), int(value.dtype == torch.bfloat16), vec, b,
            q, p, g, c, len(spatial_shapes), _level_hw(spatial_shapes), rows)
    return d_loc, d_weights


class _MSDAFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, loc, weights, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, weights)
        return msda_fwd(value, spatial_shapes, loc, weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, weights = ctx.saved_tensors
        shapes = ctx.spatial_shapes
        # The decoder's camera sum hands back an expanded (stride-0) view;
        # that one layout is copied, any other is refused by the wrappers.
        if not grad_out.is_contiguous() and 0 in grad_out.stride():
            grad_out = grad_out.contiguous()
        d_value = d_loc = d_weights = None
        if ctx.needs_input_grad[0]:
            d_value = msda_dval(value, shapes, loc, weights, grad_out)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_loc, d_weights = msda_dattn(value, shapes, loc, weights,
                                          grad_out)
        return d_value, d_loc, d_weights, None


def msda_cuda(value: torch.Tensor,
              spatial_shapes: Sequence[Tuple[int, int]],
              loc: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """MSDA on the card through the forward kernel, as an autograd node whose
    backward runs the two backward kernels."""
    return _MSDAFunction.apply(value, loc, weights,
                               tuple(tuple(s) for s in spatial_shapes))
