"""Wrapper of the hand-written CUDA int8 convolution (``csrc/qconv.cu``).

Takes the contract of ``ops/qconv.py:qconv``: x (n, h, w, ci) int8, a
contiguous tensor or a channel slice of a wider NHWC buffer; w (co, k, k, ci)
int8 with k 1 or 3, a and b (co,) float32, all contiguous; an optional `out`
(n, ho, wo, co), contiguous or a channel slice, float32 when `float_out`,
else int8; all on one CUDA device; stride 1 or 2. Returns the output, and
with `channel_sums` also its per-channel sums (n, co) float32. Anything else
raises.

Two kernels, chosen by ``route`` from the shapes and alignments alone, never
on a failure: the TMA + ``wgmma`` kernel where every row it reads or writes
is 16-byte aligned and co a multiple of 16, ``tma_plan`` picking its tile;
the first ``mma.sync`` kernel elsewhere (the stem's first conv, whose
pixels are 3 bytes, the tiny config's narrow slices). One call is one conv launch on torch's current
stream (plus one small pass for the channel sums) and adds one to
``launch_counts['qconv_tma']`` or ``launch_counts['qconv_mma']``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .qconv import out_size

LIBRARY = 'qconv'
NAMES = {'tma': 'qconv_tma', 'mma': 'qconv_mma'}   # route: kernel, counter
for _name in NAMES.values():
    _build.launch_counts.setdefault(_name, 0)

# the kernel's instantiations: N tiles of an int8 output with two consumer
# warpgroups (128-pixel tiles) and with three (192), and of a float output
TMA_WIDTHS = {(2, False): (64, 112, 128, 160, 192, 224, 256),
              (3, False): (128, 160, 192),
              (2, True): (128, 256)}


def blocks_per_sm(wgs: int, bn: int, float_out: bool) -> int:
    """Blocks of this tile an SM holds (csrc Shape::BLOCKS): two for the
    narrow tiles, whose registers allow it."""
    return 2 if wgs == 2 and (bn <= 112 or (float_out and bn == 128)) else 1


# a tile row's speed relative to two warpgroups alone on an SM: rough
# weights, set by hand so that the plan picks the tile the card ran faster
# for each of the model's convs (three warpgroups share each weight tile
# among more pixels; two blocks overlap one's epilogue with the other's
# products)
SPEED = {(2, 1): 1.0, (2, 2): 1.15, (3, 1): 1.25}
BOX_WIDTHS = (128, 64, 32, 16, 8)      # a tile's pixels in an image row

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # x, x_pitch, w, a, b, out, out_pitch, sums, n, h, w, ci, co, k, stride,
    # ho, wo, float_out, stream
    'mma': [_P, _I, _P, _P, _P, _P, _I, _P] + [_I] * 10 + [_P],
    # x, x_pitch, w, a, b, out, out_pitch, partial, sums, n, h, w, ci, co, k,
    # stride, float_out, wgs, bn, bw, bh, stream
    'tma': [_P, _I, _P, _P, _P, _P, _I, _P, _P] + [_I] * 12 + [_P],
}


class TmaPlan(NamedTuple):
    wgs: int          # consumer warpgroups (2 or 3): tiles of 64 * wgs pixels
    bn: int           # output channels of an N tile
    bw: int           # a tile is bh rows of bw pixels of one image
    bh: int
    tiles: int        # tiles an image


def _entry(route: str):
    fn = getattr(_build.load_kernel_library(LIBRARY), NAMES[route])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[route]
        fn.restype = _I
    return fn


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def spatial_box(h: int, w: int, bm: int):
    """(bw, bh) with bw * bh = bm pixels that wastes the least of an h x w
    image, the wider box on a tie."""
    return min(((bw, bm // bw) for bw in BOX_WIDTHS if bm % bw == 0),
               key=lambda s: (_ceil(w, s[0]) * s[0] * _ceil(h, s[1]) * s[1],
                              -s[0]))


def tma_plan(n: int, h: int, w: int, co: int, float_out: bool,
             sms: int) -> TmaPlan:
    """The TMA kernel's tile for this conv, the one that leaves the least
    work (rows x channels over the tile's SPEED) on the busiest of `sms`
    SMs, a wider tile on a tie. N tile: the narrowest width that holds co
    (else the widest, several tiles), or a narrower one where that leaves
    SMs idle (stage 5's 35 tiles) or where two blocks an SM pay (the concat
    convs' f32 tiles); M tile 128 pixels (two warpgroups) or, for an int8
    output, 192 (three: one round of stage 4's tiles instead of a second
    one mostly empty)."""
    best = None
    for wgs in (2, 3):
        widths = TMA_WIDTHS.get((wgs, float_out), ())
        if not widths:
            continue
        bm = 64 * wgs
        bw, bh = spatial_box(h, w, bm)
        tiles = _ceil(w, bw) * _ceil(h, bh)
        fit = next((b for b in widths if b >= co), widths[-1])
        for bn in widths[::-1]:
            blocks = blocks_per_sm(wgs, bn, float_out)
            narrow_pays = (n * tiles * _ceil(co, fit) < sms
                           or (float_out and blocks == 2))
            if bn > fit or (bn < fit and not narrow_pays):
                continue
            work = (_ceil(n * tiles * _ceil(co, bn), sms) * bm * bn
                    / SPEED[wgs, blocks])
            if best is None or work < best[0]:
                best = (work, TmaPlan(wgs, bn, bw, bh, tiles))
    return best[1]


def pitch_of(t: torch.Tensor, name: str) -> int:
    """Elements between neighbouring pixels of an NHWC tensor that is
    contiguous or a channel slice of a wider NHWC buffer; raises otherwise."""
    if t.dim() != 4:
        raise ValueError(f'{name} must be 4-d NHWC, got {t.dim()}-d')
    n, h, w, c = t.shape
    pitch = t.stride(2)
    want = (h * w * pitch, w * pitch, pitch, 1)
    if pitch < c or any(s != e for s, e, size in zip(t.stride(), want,
                                                     t.shape) if size > 1):
        raise ValueError(f'{name} {tuple(t.shape)} with strides '
                         f'{t.stride()} is not NHWC with its channels '
                         'contiguous')
    return pitch


def route(x: torch.Tensor, w: torch.Tensor, stride: int,
          out: torch.Tensor) -> str:
    """'tma' where the TMA kernel takes these operands (x's rows, the
    weights' rows and out's rows 16-byte aligned; co a multiple of 16),
    'mma' elsewhere."""
    esize = out.element_size()
    aligned = (x.shape[3] % 16 == 0
               and pitch_of(x, 'x') % 16 == 0 and x.data_ptr() % 16 == 0
               and w.shape[0] % 16 == 0
               and pitch_of(out, 'out') * esize % 16 == 0
               and out.data_ptr() % 16 == 0)
    return 'tma' if aligned else 'mma'


def _check(x, w, a, b, stride, float_out, out) -> None:
    want = {'x': (x, torch.int8, 4), 'w': (w, torch.int8, 4),
            'a': (a, torch.float32, 1), 'b': (b, torch.float32, 1)}
    tensors = [t for t, _, _ in want.values()] + [out]
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError('qconv: x, w, a, b and out must lie on one CUDA '
                         'device, got ' + ', '.join(str(t.device)
                                                   for t in tensors))
    for name, (t, dtype, dim) in want.items():
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f'qconv: {name} must be a {dim}-d {dtype}, got '
                            f'{t.dim()}-d {t.dtype}')
        if name != 'x' and not t.is_contiguous():
            raise ValueError(f'qconv: {name} must be contiguous')
        if name != 'x' and t.data_ptr() % 16:
            raise ValueError(f'qconv: {name} must be aligned to 16 bytes')
    co, k, k2, ci = w.shape
    if k != k2 or k not in (1, 3):
        raise ValueError(f'qconv: kernel {k}x{k2}; 1x1 and 3x3 are taken')
    if x.shape[3] != ci:
        raise ValueError(f'qconv: x has {x.shape[3]} channels, w {ci}')
    if tuple(a.shape) != (co,) or tuple(b.shape) != (co,):
        raise ValueError(f'qconv: a {tuple(a.shape)} and b {tuple(b.shape)} '
                         f'must be ({co},)')
    if stride not in (1, 2):
        raise ValueError(f'qconv: stride {stride}; 1 and 2 are taken')
    n, h, wd, _ = x.shape
    shape = (n, out_size(h, k, stride), out_size(wd, k, stride), co)
    if tuple(out.shape) != shape:
        raise ValueError(f'qconv: out {tuple(out.shape)}, expected {shape}')
    if out.dtype != (torch.float32 if float_out else torch.int8):
        raise TypeError(f'qconv: out is {out.dtype} with float_out='
                        f'{float_out}')
    for t, name in ((x, 'x'), (out, 'out')):
        if t.shape[0] * t.shape[1] * t.shape[2] * pitch_of(t, name) >= 2**31:
            raise ValueError(f'qconv: {name} {tuple(t.shape)} is past the '
                             'int32 index range')


def _launch(which: str, x, w, a, b, stride, float_out, out, channel_sums,
            plan: Optional[TmaPlan] = None):
    _check(x, w, a, b, stride, float_out, out)
    n, h, wd, ci = x.shape
    co, k = w.shape[0], w.shape[1]
    ho, wo = out.shape[1], out.shape[2]
    sums = (torch.empty((n, co), device=x.device, dtype=torch.float32)
            if channel_sums else None)
    if out.numel() == 0:
        return (out, sums.zero_()) if channel_sums else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xp, op = pitch_of(x, 'x'), pitch_of(out, 'out')
    sums_ptr = sums.data_ptr() if channel_sums else None
    with torch.cuda.device(x.device):
        if which == 'tma':
            if route(x, w, stride, out) != 'tma':
                raise ValueError('qconv: the TMA kernel takes 16-byte aligned '
                                 'rows and co a multiple of 16')
            plan = plan or tma_plan(n, ho, wo, co, float_out, torch.cuda
                                    .get_device_properties(x.device)
                                    .multi_processor_count)
            if plan.bn not in TMA_WIDTHS.get((plan.wgs, float_out), ()):
                raise ValueError(f'qconv: no TMA kernel for {plan}')
            partial = (torch.empty((n, plan.tiles, co), device=x.device,
                                   dtype=torch.float32)
                       if channel_sums else None)
            err = _entry('tma')(
                x.data_ptr(), xp, w.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), op,
                partial.data_ptr() if channel_sums else None, sums_ptr, n, h,
                wd, ci, co, k, stride, int(float_out), *plan[:4], stream)
        else:
            err = _entry('mma')(
                x.data_ptr(), xp, w.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), op, sums_ptr, n, h, wd, ci, co, k, stride,
                ho, wo, int(float_out), stream)
    if err != 0:
        raise RuntimeError(f'{NAMES[which]} launch failed: CUDA error {err}')
    _build.launch_counts[NAMES[which]] += 1
    return (out, sums) if channel_sums else out


def _out(x, w, stride, float_out, out):
    if out is not None:
        return out
    n, h, wd, _ = x.shape
    co, k = w.shape[0], w.shape[1]
    return torch.empty((n, out_size(h, k, stride), out_size(wd, k, stride),
                        co), device=x.device,
                       dtype=torch.float32 if float_out else torch.int8)


def qconv_cuda(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, stride: int = 1, float_out: bool = False,
               out: Optional[torch.Tensor] = None,
               channel_sums: bool = False):
    """Launch the kernel that ``route`` picks; see the module docstring."""
    if channel_sums and not float_out:
        raise ValueError('qconv: channel_sums needs the float output')
    if not x.is_cuda:
        raise ValueError(f'qconv: x must lie on a CUDA device, got {x.device}')
    out = _out(x, w, stride, float_out, out)
    return _launch(route(x, w, stride, out), x, w, a, b, stride, float_out,
                   out, channel_sums)


def qconv_tma(x, w, a, b, stride=1, float_out=False, out=None,
              channel_sums=False, plan: Optional[TmaPlan] = None):
    """The TMA kernel alone (raises where ``route`` would not take it), with
    ``tma_plan``'s tile unless `plan` names another instantiation."""
    if channel_sums and not float_out:
        raise ValueError('qconv: channel_sums needs the float output')
    return _launch('tma', x, w, a, b, stride, float_out,
                   _out(x, w, stride, float_out, out), channel_sums, plan)


def qconv_mma(x, w, a, b, stride=1, float_out=False, out=None,
              channel_sums=False):
    """The first (mma.sync) kernel alone, on any shape: the yardstick of
    the TMA kernel in ``chip_smoke.py``."""
    if channel_sums and not float_out:
        raise ValueError('qconv: channel_sums needs the float output')
    return _launch('mma', x, w, a, b, stride, float_out,
                   _out(x, w, stride, float_out, out), channel_sums)
