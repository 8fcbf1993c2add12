"""Drawing utilities of the visualization tools (the twin of
``far3d_tpu/utils/vis.py``): 3D box projection and wireframes, the BEV
canvas, 2D boxes with their scores, dots, image de-normalization and the
surround-view grid.

The geometry is the JAX module's, line for line. The drawing goes through
the port's own rasterizers in ``data/image_io.py``, since the card's machine
has no OpenCV: ``cv2.rectangle``, ``cv2.circle`` (filled, ``LINE_8``) and
``cv2.resize`` are reproduced pixel for pixel; the anti-aliased lines and
dots (``LINE_AA``) cover the pixels OpenCV's do within one pixel; the score
text is the port's stroke font at ``cv2.putText``'s anchor.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..data.image_io import (draw_line_aa, draw_polyline_aa, draw_rectangle,
                             draw_text, fill_circle, fill_circle_aa,
                             resize_linear)

# 8 corners in (x,y,z) sign order; see box_corners
EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
         (0, 4), (1, 5), (2, 6), (3, 7)]

GT_COLOR = (80, 200, 80)      # BGR green
PRED_COLOR = (80, 80, 230)    # BGR red


def box_corners(box7: np.ndarray) -> np.ndarray:
    """(7,) [x,y,z,l,w,h,yaw] -> (8,3) corners, gravity-center convention."""
    x, y, z, l, w, h, yaw = box7[:7]
    dx, dy, dz = l / 2, w / 2, h / 2
    corners = np.array([[sx * dx, sy * dy, sz * dz]
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return corners @ rot.T + np.array([x, y, z])


def draw_boxes_camera(img: np.ndarray, boxes: np.ndarray,
                      lidar2img: np.ndarray, color=PRED_COLOR,
                      thickness: int = 1) -> np.ndarray:
    """Project 3D wireframes through a 4x4 lidar2img onto `img` (in place):
    every edge whose two corners lie 0.1 in front of the camera, from the
    rounded projections of its corners."""
    for b in boxes:
        corners = box_corners(b)
        pts = np.concatenate([corners, np.ones((8, 1))], 1) @ lidar2img.T
        if (pts[:, 2] < 0.1).all():
            continue
        uv = pts[:, :2] / np.maximum(pts[:, 2:3], 1e-5)
        for i, j in EDGES:
            if pts[i, 2] > 0.1 and pts[j, 2] > 0.1:
                p0 = tuple(np.round(uv[i]).astype(int))
                p1 = tuple(np.round(uv[j]).astype(int))
                draw_line_aa(img, p0, p1, color, thickness)
    return img


def draw_bev(pred_boxes: np.ndarray, gt_boxes: np.ndarray,
             extent: float = 160.0, size: int = 800) -> np.ndarray:
    """Top-down canvas with GT (green) and predictions (red), ego at center."""
    canvas = np.full((size, size, 3), 30, np.uint8)
    scale = size / (2 * extent)

    def to_px(xy):
        return (int(size / 2 + xy[0] * scale), int(size / 2 - xy[1] * scale))

    for boxes, color in ((gt_boxes, GT_COLOR), (pred_boxes, PRED_COLOR)):
        for b in boxes:
            corners = box_corners(b)[:4, :2][[0, 1, 3, 2]]
            pts = np.array([to_px(c) for c in corners], np.int32)
            draw_polyline_aa(canvas, pts, color, closed=True)
    fill_circle(canvas, to_px((0, 0)), 4, (255, 255, 255))
    return canvas


def denormalize_image(img: np.ndarray, mean: Sequence[float],
                      std: Sequence[float]) -> np.ndarray:
    """Pipeline image -> uint8 BGR for drawing. The pipeline ships uint8
    (device-side normalization); normalized float inputs are also accepted."""
    if img.dtype == np.uint8:
        return img.copy()
    out = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def score_label(box_xyxy, score: float):
    """(text, anchor) of a box's score, as the JAX module puts it: two
    decimals, at the box's top-left corner 3 pixels up (10 at least)."""
    p0 = (int(round(box_xyxy[0])), int(round(box_xyxy[1])))
    return f'{float(score):.2f}', (p0[0], max(10, p0[1] - 3))


def draw_boxes_2d(img: np.ndarray, boxes_xyxy: np.ndarray,
                  color=PRED_COLOR, scores: Optional[np.ndarray] = None,
                  thickness: int = 1) -> np.ndarray:
    """Axis-aligned 2D boxes; optional per-box score annotation."""
    if thickness != 1:
        raise ValueError('draw_boxes_2d draws 1-pixel boxes only')
    for i, b in enumerate(boxes_xyxy):
        p0 = (int(round(b[0])), int(round(b[1])))
        p1 = (int(round(b[2])), int(round(b[3])))
        draw_rectangle(img, p0, p1, color)
        if scores is not None:
            text, org = score_label(b, scores[i])
            draw_text(img, text, org, color, 0.35)
    return img


def compose_camera_grid(images: Sequence[np.ndarray], cols: int = 3,
                        tile_w: int = 400,
                        bev: Optional[np.ndarray] = None) -> np.ndarray:
    """Surround-view composite: scale each camera to a fixed tile width, lay
    them out row-major in `cols` columns, and append the BEV canvas (scaled
    to the grid height) on the right. The tile height is the majority
    aspect's; a taller camera is center-cropped and a shorter one padded
    with black top and bottom."""
    if not images:
        raise ValueError('compose_camera_grid needs at least one image')
    heights = [int(round(img.shape[0] * tile_w / img.shape[1]))
               for img in images]
    tile_h = max(set(heights), key=heights.count)
    tiles = []
    for img, th in zip(images, heights):
        t = resize_linear(img, (tile_w, th))
        if th > tile_h:
            off = (th - tile_h) // 2
            t = t[off:off + tile_h]
        elif th < tile_h:
            pad = tile_h - th
            t = np.pad(t, ((pad // 2, pad - pad // 2), (0, 0), (0, 0)))
        tiles.append(t)
    rows = []
    for r in range(0, len(tiles), cols):
        row = tiles[r:r + cols]
        while len(row) < cols:
            row.append(np.zeros_like(tiles[0]))
        rows.append(np.concatenate(row, axis=1))
    grid = np.concatenate(rows, axis=0)
    if bev is not None:
        gh = grid.shape[0]
        bw = int(round(bev.shape[1] * gh / bev.shape[0]))
        grid = np.concatenate([grid, resize_linear(bev, (bw, gh))], axis=1)
    return grid


def depth_color(depth: np.ndarray, d_max: float = 60.0) -> np.ndarray:
    """Depth (m) -> BGR color, near=red..far=blue (plasma-like ramp)."""
    t = np.clip(np.asarray(depth, np.float32) / d_max, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(2 * t - 0.5) * 2, 0, 1)
    g = np.clip(1.5 - np.abs(2 * t - 1.0) * 2, 0, 1)
    b = np.clip(1.5 - np.abs(2 * t - 1.5) * 2, 0, 1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def draw_points(img: np.ndarray, uv: np.ndarray,
                colors: Optional[np.ndarray] = None, radius: int = 2,
                color=(0, 255, 255)) -> np.ndarray:
    """Dots at pixel coordinates uv (N,2); per-point BGR `colors` optional."""
    h, w = img.shape[:2]
    for i, p in enumerate(uv):
        x, y = int(round(float(p[0]))), int(round(float(p[1])))
        if 0 <= x < w and 0 <= y < h:
            c = tuple(int(v) for v in colors[i]) if colors is not None \
                else color
            fill_circle_aa(img, (x, y), radius, c)
    return img
