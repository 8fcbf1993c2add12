"""The port's own image reading, writing, warping and drawing.

The host data path of the JAX package calls OpenCV for four things: decoding
the camera images (``cv2.imread``), resampling each camera once onto the
model's canvas (``cv2.warpAffine``), and, in the synthetic dataset writers,
drawing filled circles (``cv2.circle``) and encoding the images
(``cv2.imwrite``). The machine with the card has no OpenCV and no PIL, so the
port does these itself:

* ``write_png`` / ``read_png``: 8-bit RGB PNG. The writer stores rows with
  filter 0 and zlib level 1. The reader decodes filter types 0-2 (None, Sub,
  Up), vectorised over rows, and raises on 3-4 (Average, Paeth), which
  encoders such as OpenCV's use: it never decodes such a file wrongly.
* ``read_image``: PNG through ``read_png``; any other file through
  ``cv2.imread``, imported at the call, which raises ``ImportError`` where
  OpenCV is absent. JPEG is not decoded without OpenCV.
* ``warp_affine_inverse``: the bilinear warp of
  ``cv2.warpAffine(img, m, (w, h), INTER_LINEAR | WARP_INVERSE_MAP,
  BORDER_CONSTANT, 0)`` for a scale and a shift per axis (all the pipeline
  composes), computed in float32 with torch on the CPU (torch's intra-op
  threads, no interpreter lock held), rows first, then columns.
* ``fill_circle``: OpenCV's filled 8-connected circle (``cv2.circle`` with
  thickness -1, ``LINE_8``, no shift), row span for row span.

Images are (H, W, 3) uint8 in BGR order, as OpenCV hands them out.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_FILTER_NAMES = {3: 'Average', 4: 'Paeth'}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack('>I', len(data)) + body
            + struct.pack('>I', zlib.crc32(body) & 0xffffffff))


def write_png(path: str, img_bgr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image as an 8-bit RGB PNG (filter 0 on
    every row, zlib level 1)."""
    img = np.asarray(img_bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'write_png takes (H, W, 3) uint8, got '
                         f'{img.shape} {img.dtype}')
    h, w, _ = img.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = img[..., [2, 1, 0]].reshape(h, 3 * w)
    header = struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(_PNG_SIGNATURE + _chunk(b'IHDR', header)
                + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 1))
                + _chunk(b'IEND', b''))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced RGB PNG whose rows use filter types
    0-2 into (H, W, 3) uint8 BGR."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f'{path}: not a PNG file')
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f'{path}: no IHDR chunk')
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour != 2 or interlace:
        raise ValueError(f'{path}: only 8-bit non-interlaced RGB PNG is read '
                         f'(bit depth {depth}, colour type {colour}, '
                         f'interlace {interlace})')
    rows = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    ftype = rows[:, 0]
    bad = sorted(set(np.unique(ftype).tolist()) - {0, 1, 2})
    if bad:
        names = ', '.join(f'{t} ({_FILTER_NAMES.get(t, "unknown")})'
                          for t in bad)
        raise ValueError(f'{path}: PNG filter type {names} is not decoded; '
                         'only types 0-2 (None, Sub, Up) are')
    out = rows[:, 1:].copy()
    sub = ftype == 1
    if sub.any():      # Sub: a running sum along the row, per channel
        out[sub] = np.cumsum(out[sub].reshape(-1, w, 3), axis=1,
                             dtype=np.uint8).reshape(-1, 3 * w)
    up = ftype == 2
    if up.any():       # Up: a running sum down each run of Up rows
        total = np.cumsum(out, axis=0, dtype=np.uint8)
        idx = np.arange(h)
        start = np.maximum.accumulate(np.where(up, 0, idx))
        before = np.where((start > 0)[:, None], total[start - 1], 0)
        out = (total - before).astype(np.uint8)
    return out.reshape(h, w, 3)[..., [2, 1, 0]]


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of a PNG (own decoder) or, through OpenCV, of any
    other image file."""
    if str(path).lower().endswith('.png'):
        return read_png(path)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f'{path}: only PNG is decoded without OpenCV (cv2), which is not '
            'installed here; write the dataset as PNG') from e
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _taps(coord: torch.Tensor, n: int):
    """The two bilinear taps of each source coordinate along one axis:
    [(index clamped into [0, n), weight, zero for a tap outside)] x 2."""
    lo = torch.floor(coord)
    frac = coord - lo
    out = []
    for d, weight in ((0, 1.0 - frac), (1, frac)):
        idx = lo.long() + d
        inside = (idx >= 0) & (idx < n)
        out.append((idx.clamp(0, n - 1), weight * inside))
    return out


def warp_affine_inverse(img: np.ndarray, m: np.ndarray,
                        out_wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear inverse-map affine warp with a zero border, for the maps the
    pipeline composes: a scale and a shift per axis (no rotation or shear,
    which raise).

    Output pixel (x, y) samples the source at m @ (x, y, 1); a tap outside
    the source counts as 0. Rows are interpolated first, then columns, with
    float32 weights, rounded half to even into uint8. img (H, W, C) uint8;
    m (2, 3); out_wh (width, height). Returns (height, width, C) uint8."""
    m = np.asarray(m, np.float64)
    if m[0, 1] != 0 or m[1, 0] != 0:
        raise ValueError(f'warp_affine_inverse takes a scale and a shift per '
                         f'axis, not a rotation or shear: {m.tolist()}')
    src = torch.from_numpy(np.ascontiguousarray(img))
    h, w, _ = src.shape
    ow, oh = out_wh
    sx = torch.from_numpy(m[0, 0] * np.arange(ow) + m[0, 2]).float()
    sy = torch.from_numpy(m[1, 1] * np.arange(oh) + m[1, 2]).float()
    (y0, wy0), (y1, wy1) = _taps(sy, h)
    (x0, wx0), (x1, wx1) = _taps(sx, w)
    rows = (wy0[:, None, None] * src.index_select(0, y0).float()
            + wy1[:, None, None] * src.index_select(0, y1).float())
    out = (wx0[None, :, None] * rows.index_select(1, x0)
           + wx1[None, :, None] * rows.index_select(1, x1))
    return out.round_().clamp_(0, 255).to(torch.uint8).numpy()


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int,
                color: Sequence[float]) -> None:
    """Draw a filled circle in place, pixel for pixel as ``cv2.circle(img,
    center, radius, color, -1)`` does (OpenCV's midpoint circle, whose row
    spans are filled; the colour rounded half to even and saturated)."""
    cx, cy = center
    h, w = img.shape[:2]
    value = np.clip(np.rint(np.asarray(color, np.float64)[:img.shape[2]]),
                    0, 255).astype(img.dtype)

    def span(y, x1, x2):
        if 0 <= y < h and x1 < w and x2 >= 0:
            img[y, max(x1, 0):min(x2, w - 1) + 1] = value

    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
