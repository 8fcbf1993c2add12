"""The port's own image reading, writing, warping and drawing.

The host data path of the JAX package calls OpenCV for four things: decoding
the camera images (``cv2.imread``), resampling each camera once onto the
model's canvas (``cv2.warpAffine``), and, in the synthetic dataset writers,
drawing filled circles (``cv2.circle``) and encoding the images
(``cv2.imwrite``); its visualization tools draw lines, rectangles, dots and
text and resize images with OpenCV. The machine with the card has no OpenCV
and no PIL, so the port does these itself:

* ``write_png`` / ``read_png``: 8-bit RGB PNG. The writer stores rows with
  filter 0 and zlib level 1. The reader decodes all five filter types of
  the PNG specification: a file of types 0-2 (None, Sub, Up) with running
  sums vectorised over rows and columns; one with any Average (3) or Paeth
  (4) row, as OpenCV's and most encoders write, along anti-diagonals of
  pixels, since those filters predict a byte from its decoded left and
  upper neighbours.
* ``write_jpeg`` / ``read_image``: baseline JPEG through the port's codec
  (``data/jpeg.py``), equal bit for bit to ``cv2.imwrite`` at a quality and
  ``cv2.imread``. ``read_image`` tells PNG from JPEG by the file's first
  bytes and raises on any other format.
* ``warp_affine_inverse``: the bilinear warp of
  ``cv2.warpAffine(img, m, (w, h), INTER_LINEAR | WARP_INVERSE_MAP,
  BORDER_CONSTANT, 0)`` for a scale and a shift per axis (all the pipeline
  composes), computed in float32 with torch on the CPU (torch's intra-op
  threads, no interpreter lock held), rows first, then columns.
* ``resize_linear`` / ``resize_nearest``: ``cv2.resize`` with
  ``INTER_LINEAR`` (OpenCV's fixed-point uint8 path) and ``INTER_NEAREST``.
* ``fill_circle``: OpenCV's filled 8-connected circle (``cv2.circle`` with
  thickness -1, ``LINE_8``, no shift), row span for row span.
* ``fill_poly``: OpenCV's filled polygon (``cv2.fillPoly`` of one contour,
  ``LINE_8``, no shift): the outline's 8-connected lines, then the even-odd
  scanline fill over the edges in OpenCV's 16-bit fixed point.
* ``draw_rectangle`` (``cv2.rectangle``, ``LINE_8``), ``draw_line_aa``
  (``cv2.line`` with ``LINE_AA``), ``fill_circle_aa`` (``cv2.circle``
  filled, ``LINE_AA``) and ``draw_text`` (a small stroke font of the port's
  own where the tools call ``cv2.putText``).

Images are (H, W, 3) uint8 in BGR order, as OpenCV hands them out.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


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
    """Decode an 8-bit, non-interlaced RGB PNG into (H, W, 3) uint8 BGR."""
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
    bad = sorted(set(np.unique(ftype).tolist()) - {0, 1, 2, 3, 4})
    if bad:
        raise ValueError(f'{path}: PNG filter type {bad} does not exist')
    if (ftype > 2).any():
        out = _unfilter_diagonals(rows[:, 1:].reshape(h, w, 3), ftype)
        return out[..., [2, 1, 0]]
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


def _unfilter_diagonals(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters of the PNG specification (section 9.2) on
    (H, W, 3) filtered bytes, whatever mix of types 0-4 the rows use. Byte
    x of row y is raw + predictor(a, b, c) mod 256 with a its decoded left
    neighbour (one pixel, 3 bytes, back), b the one above, c the one above
    a; Average predicts floor((a + b) / 2), Paeth whichever of a, b, c is
    nearest a + b - c (ties to a, then b). Every pixel of an anti-diagonal
    y + x = k depends only on diagonals k - 1 and k - 2, so each diagonal is
    one vectorised step: h + w - 1 steps."""
    h, w, _ = raw.shape
    out = np.zeros((h + 1, w + 1, 3), np.int16)   # a zero row and column
    px = raw.astype(np.int16)
    kinds = ftype.astype(np.int16)
    for k in range(h + w - 1):
        y = np.arange(max(0, k - w + 1), min(h, k + 1))
        x = k - y
        a = out[y + 1, x]
        b = out[y, x + 1]
        c = out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = kinds[y][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (px[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write an (H, W, 3) uint8 BGR (or (H, W) gray) image as baseline JPEG,
    the bytes of ``cv2.imwrite(path, img, [IMWRITE_JPEG_QUALITY,
    quality])``."""
    from .jpeg import encode_jpeg
    data = encode_jpeg(img, quality)
    with open(path, 'wb') as f:
        f.write(data)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of a PNG or a JPEG file, told apart by their
    first bytes; the pixels ``cv2.imread(path, IMREAD_COLOR)`` gives."""
    with open(path, 'rb') as f:
        head = f.read(8)
    if head == _PNG_SIGNATURE:
        return read_png(path)
    if head[:2] == b'\xff\xd8':
        from .jpeg import decode_jpeg
        with open(path, 'rb') as f:
            return decode_jpeg(f.read())
    raise ValueError(f'{path}: neither PNG nor JPEG (the two formats the '
                     'port decodes)')


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


def _color_value(img: np.ndarray, color: Sequence[float]) -> np.ndarray:
    """OpenCV's colour for `img`: the first channels of `color`, rounded
    half to even and saturated to uint8."""
    n = img.shape[2] if img.ndim == 3 else 1
    value = np.clip(np.rint(np.asarray(color, np.float64)[:n]), 0, 255)
    value = value.astype(img.dtype)
    return value if img.ndim == 3 else value[0]


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int,
                color: Sequence[float]) -> None:
    """Draw a filled circle in place, pixel for pixel as ``cv2.circle(img,
    center, radius, color, -1)`` does (OpenCV's midpoint circle, whose row
    spans are filled; the colour rounded half to even and saturated)."""
    cx, cy = center
    h, w = img.shape[:2]
    value = _color_value(img, color)

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


_XY_SHIFT = 16                 # OpenCV's fixed point for edges and AA lines


def _line8(img: np.ndarray, p0, p1, value) -> None:
    """OpenCV's 8-connected line (``LineIterator`` left to right) from p0 to
    p1, both inside the image."""
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = x1 - x0, y1 - y0
    if dx < 0:
        x0, y0, dx, dy = x1, y1, -dx, -dy
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = value
        bump = err < 0
        err += -2 * dy + (2 * dx if bump else 0)
        if vert:
            y += sy
            x += 1 if bump else 0
        else:
            x += 1
            y += sy if bump else 0


def fill_poly(img: np.ndarray, points: np.ndarray, color: Sequence[float]
              ) -> None:
    """Fill one polygon in place, pixel for pixel as ``cv2.fillPoly(img,
    [points], color)`` does: each edge drawn as OpenCV's 8-connected line,
    then, row by row, the spans between pairs of the non-horizontal edges
    that cross the row (an edge covers rows y0 <= y < y1, its x advancing
    from the top vertex by (x1 - x0) / (y1 - y0), truncated, in 16-bit
    fixed point), taken in x order, from the left x rounded up to the right
    x rounded down: the even-odd rule. `points` (N, 2) are integer (x, y)
    vertices, all inside the image."""
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    h, w = img.shape[:2]
    if len(pts) == 0:
        return
    if (pts < 0).any() or (pts[:, 0] >= w).any() or (pts[:, 1] >= h).any():
        raise ValueError('fill_poly takes vertices inside the image only')
    value = _color_value(img, color)
    prev = np.roll(pts, 1, axis=0)
    edges = []                                  # (y0, y1, x at y0, dx)
    for (xa, ya), (xb, yb) in zip(prev.tolist(), pts.tolist()):
        _line8(img, (xa, ya), (xb, yb), value)
        if ya == yb:
            continue
        num, den = (xb - xa) << _XY_SHIFT, yb - ya
        dx = abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)
        if ya < yb:
            edges.append((ya, yb, xa << _XY_SHIFT, dx))
        else:
            edges.append((yb, ya, xb << _XY_SHIFT, dx))
    if len(edges) < 2:
        return
    e = np.asarray(edges, np.int64)
    for y in range(int(e[:, 0].min()), min(int(e[:, 1].max()), h)):
        live = e[(e[:, 0] <= y) & (y < e[:, 1])]
        xs = np.sort(live[:, 2] + (y - live[:, 0]) * live[:, 3])
        left = (xs[0::2] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
        for xl, xr in zip(left, xs[1::2] >> _XY_SHIFT):
            if xl < w and xr >= 0:
                img[y, max(xl, 0):min(xr, w - 1) + 1] = value


def clip_line(size: Tuple[int, int], p0, p1):
    """``cv2.clipLine((0, 0, w, h), p0, p1)``: the part of the segment
    inside the image of size (w, h), by OpenCV's integer clipping (each
    crossing truncated toward zero). Returns (inside, p0, p1)."""
    w, h = size
    (x1, y1), (x2, y2) = (int(v) for v in p0), (int(v) for v in p1)
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, (x1, y1), (x2, y2)

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _blend(img: np.ndarray, ys, xs, value: np.ndarray, alpha) -> None:
    """img[ys, xs] moved toward `value` by alpha in [0, 1], rounded."""
    old = img[ys, xs].astype(np.float32)
    a = np.asarray(alpha, np.float32).reshape(
        (-1,) + (1,) * (old.ndim - 1))
    img[ys, xs] = np.rint(old + (value.astype(np.float32) - old) * a
                          ).astype(img.dtype)


def draw_line_aa(img: np.ndarray, p0, p1, color: Sequence[float],
                 thickness: int = 1) -> None:
    """An anti-aliased 1-pixel line in place, where the tools call
    ``cv2.line(img, p0, p1, color, 1, LINE_AA)``: the segment clipped to the
    image in OpenCV's 16-bit fixed point (``clip_line`` on the scaled
    coordinates, as its anti-aliased line clips), then one step a column
    (or a row, for a steep line) covering the two pixels nearest the exact
    line by their share of it (Xiaolin Wu's line). OpenCV's own filter
    covers three pixels a step with other weights: the pixels either
    changes lie within one pixel of the other's."""
    if thickness != 1:
        raise ValueError('draw_line_aa draws 1-pixel lines only')
    h, w = img.shape[:2]
    one = 1 << _XY_SHIFT
    inside, a, b = clip_line((w * one, h * one),
                             (int(p0[0]) * one, int(p0[1]) * one),
                             (int(p1[0]) * one, int(p1[1]) * one))
    if not inside:
        return
    (x0, y0), (x1, y1) = ((v / one for v in a)), ((v / one for v in b))
    value = _color_value(img, color)
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    if x0 > x1:
        x0, y0, x1, y1 = x1, y1, x0, y0
    xs = np.arange(int(np.floor(x0)), int(np.floor(x1)) + 1)
    slope = (y1 - y0) / (x1 - x0) if x1 != x0 else 0.0
    ys = y0 + slope * (xs - x0)
    lo = np.floor(ys).astype(np.int64)
    frac = (ys - lo).astype(np.float32)
    limit = w if steep else h
    for rows, alpha in ((lo, 1.0 - frac), (lo + 1, frac)):
        keep = (rows >= 0) & (rows < limit) & (alpha > 0)
        r, c, al = rows[keep], xs[keep], alpha[keep]
        if steep:
            _blend(img, c, r, value, al)
        else:
            _blend(img, r, c, value, al)


def draw_polyline_aa(img: np.ndarray, points, color: Sequence[float],
                     closed: bool = True) -> None:
    """``cv2.polylines(img, [points], closed, color, 1, LINE_AA)``: each
    edge through ``draw_line_aa``."""
    pts = [tuple(int(v) for v in p) for p in np.asarray(points).reshape(-1, 2)]
    pairs = list(zip(pts[:-1], pts[1:]))
    if closed and len(pts) > 1:
        pairs.append((pts[-1], pts[0]))
    for a, b in pairs:
        draw_line_aa(img, a, b, color)


def draw_rectangle(img: np.ndarray, p0, p1, color: Sequence[float]) -> None:
    """``cv2.rectangle(img, p0, p1, color, 1)`` (``LINE_8``) in place,
    pixel for pixel: the four axis-parallel edges, clipped to the image."""
    h, w = img.shape[:2]
    value = _color_value(img, color)
    (xa, ya), (xb, yb) = (int(v) for v in p0), (int(v) for v in p1)
    for y in (ya, yb):                                # horizontal edges
        if 0 <= y < h:
            lo, hi = max(min(xa, xb), 0), min(max(xa, xb), w - 1)
            if lo <= hi:
                img[y, lo:hi + 1] = value
    for x in (xa, xb):                                # vertical edges
        if 0 <= x < w:
            lo, hi = max(min(ya, yb), 0), min(max(ya, yb), h - 1)
            if lo <= hi:
                img[lo:hi + 1, x] = value


def fill_circle_aa(img: np.ndarray, center: Tuple[int, int], radius: int,
                   color: Sequence[float]) -> None:
    """A filled anti-aliased circle in place, where the tools call
    ``cv2.circle(img, center, radius, color, -1, LINE_AA)``: each pixel
    moved toward the colour by its coverage, min(1, radius + 0.5 - its
    distance from the centre) where positive. OpenCV fills a polygon of the
    circle with an anti-aliased edge: the pixels either changes lie within
    one pixel of the other's."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    r = int(radius)
    y0, y1 = max(cy - r - 1, 0), min(cy + r + 1, h - 1)
    x0, x1 = max(cx - r - 1, 0), min(cx + r + 1, w - 1)
    if y0 > y1 or x0 > x1:
        return
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    cover = np.clip(r + 0.5 - np.hypot(xx - cx, yy - cy), 0.0, 1.0)
    keep = cover > 0
    _blend(img, yy[keep], xx[keep], _color_value(img, color), cover[keep])


def _linear_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: the two source indices
    (clamped into the image) and their 11-bit weights; the weights come
    from the unclamped position, as its fixed-point path takes them."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, 2048 - w0


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of a uint8 image, bit
    for bit: OpenCV's fixed-point path (11-bit weights; rows summed in int,
    then columns as its vector code does, each product's top 16 bits, then a
    rounding shift by 2), and its 2x2 box average for an exact halving."""
    w, h = size
    sh, sw = img.shape[:2]
    src = np.asarray(img)
    if sh == 2 * h and sw == 2 * w:
        s = src.astype(np.int32)
        out = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
               + 2) >> 2
        return out.astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(sw, w)
    y0, y1, b0, b1 = _linear_taps(sh, h)
    extra = (None,) * (src.ndim - 2)
    s = src.astype(np.int64)
    rows = s[:, x0] * a0[(None, slice(None)) + extra] \
        + s[:, x1] * a1[(None, slice(None)) + extra]
    col = (slice(None), None) + extra
    v = (((rows[y0] >> 4) * b0[col]) >> 16) + (((rows[y1] >> 4) * b1[col])
                                               >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST)``."""
    w, h = size
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(
        np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(
        np.int64), sh - 1)
    return np.ascontiguousarray(np.asarray(img)[ys][:, xs])


# A small stroke font: each glyph is a list of strokes on a 4 x 6 grid
# (x right, y down from the top), drawn as anti-aliased lines.
_GLYPHS = {
    '0': [(0, 0, 4, 0), (4, 0, 4, 6), (4, 6, 0, 6), (0, 6, 0, 0)],
    '1': [(2, 0, 2, 6), (1, 1, 2, 0)],
    '2': [(0, 0, 4, 0), (4, 0, 4, 3), (4, 3, 0, 3), (0, 3, 0, 6),
          (0, 6, 4, 6)],
    '3': [(0, 0, 4, 0), (4, 0, 4, 6), (4, 6, 0, 6), (1, 3, 4, 3)],
    '4': [(0, 0, 0, 3), (0, 3, 4, 3), (4, 0, 4, 6)],
    '5': [(4, 0, 0, 0), (0, 0, 0, 3), (0, 3, 4, 3), (4, 3, 4, 6),
          (4, 6, 0, 6)],
    '6': [(4, 0, 0, 0), (0, 0, 0, 6), (0, 6, 4, 6), (4, 6, 4, 3),
          (4, 3, 0, 3)],
    '7': [(0, 0, 4, 0), (4, 0, 1, 6)],
    '8': [(0, 0, 4, 0), (4, 0, 4, 6), (4, 6, 0, 6), (0, 6, 0, 0),
          (0, 3, 4, 3)],
    '9': [(4, 3, 0, 3), (0, 3, 0, 0), (0, 0, 4, 0), (4, 0, 4, 6),
          (4, 6, 0, 6)],
    '-': [(0, 3, 4, 3)],
    '.': [(1, 5, 1, 6), (2, 5, 2, 6)],
}


def draw_text(img: np.ndarray, text: str, org: Tuple[int, int],
              color: Sequence[float], scale: float = 0.35) -> None:
    """Digits, '-' and '.' in place with the port's stroke font, where the
    tools call ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale,
    color, 1, LINE_AA)``: `org` is the bottom-left corner of the text, as
    there, and a glyph is about as tall as that font's digits at `scale`.
    Other characters advance without a mark."""
    unit = max(22.0 * scale / 6.0, 1.0)
    x, y = float(org[0]), float(org[1]) - 6.0 * unit
    for ch in text:
        for ax, ay, bx, by in _GLYPHS.get(ch, ()):
            draw_line_aa(img, (int(round(x + ax * unit)),
                               int(round(y + ay * unit))),
                         (int(round(x + bx * unit)),
                          int(round(y + by * unit))), color)
        x += 6.0 * unit
