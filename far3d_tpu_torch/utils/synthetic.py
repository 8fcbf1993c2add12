"""Seeded synthetic inference inputs (plain numpy; counterpart of the
inference part of ``far3d_tpu/utils/synthetic.py``): pinhole cameras in a
ring and random normalized images."""

from __future__ import annotations

from typing import Dict

import numpy as np

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
