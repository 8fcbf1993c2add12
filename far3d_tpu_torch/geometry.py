"""Kernel-free geometry and codec helpers (plain torch).

Counterpart of ``far3d_tpu/geometry.py``, limited to what the inference and
training paths use: LID depth binning, the box codec, the sine / NeRF
positional encodings, and the SE3 and projection helpers.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .utils.constants import constant


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically clamped logit (mmdet transformer.inverse_sigmoid)."""
    x = x.clamp(0.0, 1.0)
    return x.clamp(min=eps).log() - (1.0 - x).clamp(min=eps).log()


def lid_bin_size(depth_min: float, depth_max: float, num_bins: int) -> float:
    return 2.0 * (depth_max - depth_min) / (num_bins * (1 + num_bins))


def lid_bin_to_depth(indices: torch.Tensor, depth_min: float,
                     depth_max: float, num_bins: int) -> torch.Tensor:
    """Bin index -> metric depth (farhead.py:524-527):
    depth = depth_min + bin_size/8 * ((i/0.5 + 1)^2 - 1)."""
    bs = lid_bin_size(depth_min, depth_max, num_bins)
    i = indices.float()
    return depth_min + bs / 8.0 * ((i / 0.5 + 1.0).square() - 1.0)


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """Metric (cx,cy,cz,w,l,h,yaw[,vx,vy]) -> normalized code
    (x,y,z, log w,l,h, sin,cos[,vx,vy]) (util.py:4-23)."""
    rot = bboxes[..., 6:7]
    parts = [bboxes[..., 0:3], bboxes[..., 3:6].log(), rot.sin(), rot.cos()]
    if bboxes.shape[-1] > 7:
        parts.append(bboxes[..., 7:9])
    return torch.cat(parts, dim=-1)


def denormalize_bbox(code: torch.Tensor) -> torch.Tensor:
    """Normalized code (x,y,z, log w,l,h, sin,cos[,vx,vy]) -> metric
    (cx,cy,cz,w,l,h,yaw[,vx,vy]) (util.py:25-52)."""
    rot = torch.atan2(code[..., 6:7], code[..., 7:8])
    parts = [code[..., 0:3], code[..., 3:6].exp(), rot]
    if code.shape[-1] > 8:
        parts.append(code[..., 8:10])
    return torch.cat(parts, dim=-1)


def _sine_embed(pos: torch.Tensor, num_pos_feats: int,
                temperature: float) -> torch.Tensor:
    """pos (...,) -> (..., num_pos_feats) interleaved sin/cos."""
    pos = pos * (2.0 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    x = pos[..., None] / dim_t
    emb = torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], dim=-1)
    return emb.flatten(-2)


def pos2posemb3d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """(..., 3) normalized xyz -> (..., 3*num_pos_feats) in [y, x, z] order
    (positional_encoding.py:13-25)."""
    ex = _sine_embed(pos[..., 0], num_pos_feats, temperature)
    ey = _sine_embed(pos[..., 1], num_pos_feats, temperature)
    ez = _sine_embed(pos[..., 2], num_pos_feats, temperature)
    return torch.cat([ey, ex, ez], dim=-1)


def pos2posemb1d(pos: torch.Tensor, num_pos_feats: int = 256,
                 temperature: float = 10000.0) -> torch.Tensor:
    """(..., 1) -> (..., num_pos_feats) (positional_encoding.py:27-36)."""
    return _sine_embed(pos[..., 0], num_pos_feats, temperature)


def nerf_positional_encoding(x: torch.Tensor,
                             num_encoding_functions: int = 6) -> torch.Tensor:
    """NeRF log-sampled sin/cos bands without the input passthrough
    (positional_encoding.py:38-80): (..., D) -> (..., D*2*num_fn)."""
    out = []
    for i in range(num_encoding_functions):
        f = 2.0 ** i
        out.append(torch.sin(x * f))
        out.append(torch.cos(x * f))
    return torch.cat(out, dim=-1)


def _homogeneous(points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def transform_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous 4x4 `matrix` (..., 4, 4) to `points` (..., N, 3)
    (misc.py:193-202)."""
    return (_homogeneous(points) @ matrix.transpose(-1, -2))[..., :3]


def unproject_to_lidar(uv: torch.Tensor, depth: torch.Tensor,
                       img2lidar: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(u, v) pixels + metric depth -> ego-frame points (farhead.py:792-811).

    uv (..., 2); depth (..., 1); img2lidar (..., 4, 4) -> (..., 3)."""
    d = depth.clamp(min=eps)
    coords = torch.cat([uv * d, depth, torch.ones_like(depth)], dim=-1)
    return (img2lidar @ coords[..., None])[..., :3, 0]


def project_to_image(points: torch.Tensor, lidar2img: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ego-frame points (..., 3) -> (uv (..., 2), depth (..., 1)) with
    uv = xy / clamp(z, eps) (detr3d_transformer.py:547-552)."""
    cam = (lidar2img @ _homogeneous(points)[..., None])[..., 0]
    depth = cam[..., 2:3]
    return cam[..., :2] / depth.clamp(min=eps), depth


def _range(pc_range: Sequence[float], like: torch.Tensor):
    lo = constant(pc_range[:3], like.dtype, like.device)
    hi = constant(pc_range[3:6], like.dtype, like.device)
    return lo, hi


def normalize_to_pc_range(points: torch.Tensor, pc_range) -> torch.Tensor:
    """Metric xyz -> [0, 1]^3 within the point-cloud range."""
    lo, hi = _range(pc_range, points)
    return (points - lo) / (hi - lo)


def denormalize_from_pc_range(points: torch.Tensor, pc_range) -> torch.Tensor:
    lo, hi = _range(pc_range, points)
    return points * (hi - lo) + lo
