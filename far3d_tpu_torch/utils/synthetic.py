"""Seeded synthetic inputs (plain numpy; counterpart of
``far3d_tpu/utils/synthetic.py``'s ``ring_cameras`` and ``synthetic_batch``):
pinhole cameras in a ring, random normalized images, and for training random
GT boxes with their 2D boxes and painted depth bins."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Far3DConfig


def ring_cameras(n: int, h: int, w: int, fov_deg: float = 70.0):
    """n pinhole cameras looking outward in a ring (ego frame: x forward,
    y left, z up). Returns (intrinsics (n,4,4), extrinsics (n,4,4) = ego->cam)."""
    f = w / (2 * np.tan(np.radians(fov_deg) / 2))
    intr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr[:, 0, 0] = f
    intr[:, 1, 1] = f
    intr[:, 0, 2] = w / 2
    intr[:, 1, 2] = h / 2
    extr = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        yaw = 2 * np.pi * i / n
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])   # optical axis
        left = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        # camera frame: x right, y down, z forward
        extr[i, :3, :3] = np.stack([-left, -up, fwd], axis=0)
        extr[i, 3, 3] = 1.0
    return intr, extr


def inference_inputs(cfg: Far3DConfig, batch: int = 1,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """One frame of inference inputs, as the JAX package's
    ``synthetic_batch(cfg, batch, seed)`` makes them: the same random images
    (its first draw) and ring cameras, identity ego pose, a fresh stream."""
    rng = np.random.RandomState(seed)
    n = cfg.data.num_cams
    h, w = cfg.data.input_hw
    intr, extr = ring_cameras(n, h, w)
    lidar2img = np.einsum('nij,njk->nik', intr, extr)
    eye = np.tile(np.eye(4, dtype=np.float32)[None], (batch, 1, 1))
    return dict(
        images=rng.randn(batch, n, h, w, 3).astype(np.float32),
        lidar2img=np.tile(lidar2img[None], (batch, 1, 1, 1)).astype(np.float32),
        intrinsics=np.tile(intr[None], (batch, 1, 1, 1)),
        extrinsics=np.tile(extr[None], (batch, 1, 1, 1)),
        timestamp=np.zeros((batch,), np.float32),
        prev_exists=np.zeros((batch,), np.float32),
        ego_pose=eye.copy(),
        ego_pose_inv=eye.copy(),
    )


def synthetic_batch(cfg: Far3DConfig, batch: int = 1,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """One training frame per batch lane, the draws of the JAX package's
    ``synthetic_batch(cfg, batch, seed)`` (synthetic.py:456-544) in the same
    order, as a dict of CPU tensors with its keys: random images and ring
    cameras; up to max_gt random boxes in the pc range; for each camera the
    2D boxes, centers and labels of the GT centers it sees, and their LID
    depth bins painted on the stride-8 grid."""
    rng = np.random.RandomState(seed)
    n = cfg.data.num_cams
    h, w = cfg.data.input_hw
    g = cfg.data.max_gt
    g2 = cfg.data.max_gt_2d
    dcfg = cfg.depthnet
    h8, w8 = h // dcfg.stride, w // dcfg.stride

    intr, extr = ring_cameras(n, h, w)
    lidar2img = np.einsum('nij,njk->nik', intr, extr)
    images = rng.randn(batch, n, h, w, 3).astype(np.float32)

    lo = np.asarray(cfg.pc_range[:3])
    hi = np.asarray(cfg.pc_range[3:6])
    centers = rng.uniform(lo, hi, size=(batch, g, 3)).astype(np.float32)
    sizes = rng.uniform(0.5, 4.0, size=(batch, g, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, size=(batch, g, 1)).astype(np.float32)
    gt_boxes = np.concatenate([centers, sizes, yaw], axis=-1)
    n_gt = rng.randint(1, g + 1, size=(batch,))
    gt_mask = np.arange(g)[None] < n_gt[:, None]
    gt_labels = rng.randint(0, cfg.num_classes, size=(batch, g))

    gt_boxes2d = np.zeros((batch, n, g2, 4), np.float32)
    gt_labels2d = np.zeros((batch, n, g2), np.int64)
    gt_centers2d = np.zeros((batch, n, g2, 2), np.float32)
    gt_mask2d = np.zeros((batch, n, g2), bool)
    depth_bins = np.full((batch, n, h8 * w8), dcfg.num_depth_bins, np.int32)
    depth_fg = np.zeros((batch, n, h8 * w8), bool)
    bs = 2 * (dcfg.depth_max - dcfg.depth_min) / (
        dcfg.num_depth_bins * (1 + dcfg.num_depth_bins))
    for b in range(batch):
        for cam in range(n):
            cnt = 0
            for gi in range(int(n_gt[b])):
                uvd = lidar2img[cam] @ np.concatenate([centers[b, gi], [1.0]])
                if uvd[2] < 1.0:
                    continue
                u, v = uvd[0] / uvd[2], uvd[1] / uvd[2]
                if not (0 <= u < w and 0 <= v < h) or cnt >= g2:
                    continue
                bw = 40.0 * rng.rand() + 8
                bh = 30.0 * rng.rand() + 8
                box = [max(u - bw, 0), max(v - bh, 0), min(u + bw, w - 1),
                       min(v + bh, h - 1)]
                gt_boxes2d[b, cam, cnt] = box
                gt_centers2d[b, cam, cnt] = [u, v]
                gt_labels2d[b, cam, cnt] = gt_labels[b, gi]
                gt_mask2d[b, cam, cnt] = True
                # the instance's LID bin, painted over its 2D box
                idx = -0.5 + 0.5 * np.sqrt(1 + 8 * (uvd[2] - dcfg.depth_min) / bs)
                idx = int(np.clip(idx, 0, dcfg.num_depth_bins))
                box = gt_boxes2d[b, cam, cnt]
                u8a, v8a = int(box[0] // 8), int(box[1] // 8)
                u8b, v8b = int(np.ceil(box[2] / 8)), int(np.ceil(box[3] / 8))
                for vv in range(max(v8a, 0), min(v8b, h8)):
                    for uu in range(max(u8a, 0), min(u8b, w8)):
                        depth_bins[b, cam, vv * w8 + uu] = idx
                        depth_fg[b, cam, vv * w8 + uu] = True
                cnt += 1

    eye = np.tile(np.eye(4, dtype=np.float32)[None], (batch, 1, 1))
    data = dict(
        images=images,
        lidar2img=np.tile(lidar2img[None], (batch, 1, 1, 1)),
        intrinsics=np.tile(intr[None], (batch, 1, 1, 1)),
        extrinsics=np.tile(extr[None], (batch, 1, 1, 1)),
        timestamp=np.zeros((batch,), np.float32),
        prev_exists=np.zeros((batch,), np.float32),
        ego_pose=eye.copy(), ego_pose_inv=eye.copy(),
        gt_boxes=gt_boxes,
        gt_velocity=(rng.uniform(-2, 2, (batch, g, 2)) * gt_mask[..., None]
                     ).astype(np.float32),
        gt_labels=gt_labels, gt_mask=gt_mask,
        gt_boxes2d=gt_boxes2d, gt_labels2d=gt_labels2d,
        gt_centers2d=gt_centers2d, gt_mask2d=gt_mask2d,
        gt_depth_bins=depth_bins, gt_depth_fg=depth_fg)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
