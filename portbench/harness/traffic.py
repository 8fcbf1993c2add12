"""The general traffic generator: every input a run hands the program, made
from the run's seed and the numbers of its traffic file.

Streaming (``kind: stream``): one camera rig at batch 1, closed loop. A
pool of seeded uint8 frames in pinned host memory, visited in a seeded
order; the ego pose drives along a seeded trajectory (a speed and a yaw
rate drawn per scene), timestamps step by ``frame_dt_s`` from the scene's
start, and every ``scene_frames`` frames a new scene starts
(``prev_exists`` 0). Every seed gives the same sizes and the same arrivals
in another order.

Training (``kind: train``): a pool of seeded synthetic batches, the
draws of the port's ``utils/synthetic.py:synthetic_batch`` (copied here,
with the images drawn as uint8 on the card), cycled.

The ring of pinhole cameras is the port's ``utils/synthetic.py:
ring_cameras``, copied."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def sub_seed(seed: int, purpose: int) -> int:
    """A 32-bit seed for one purpose of a run, from its (any size) seed."""
    return int(np.random.SeedSequence([seed, purpose]).generate_state(1)[0])


def ring_cameras(n: int, h: int, w: int, fov_deg: float = 70.0):
    """n pinhole cameras looking outward in a ring (ego frame: x forward,
    y left, z up). Returns (intrinsics (n,4,4), extrinsics (n,4,4) =
    ego->cam)."""
    f = w / (2 * np.tan(np.radians(fov_deg) / 2))
    intr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr[:, 0, 0] = f
    intr[:, 1, 1] = f
    intr[:, 0, 2] = w / 2
    intr[:, 1, 2] = h / 2
    extr = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        yaw = 2 * np.pi * i / n
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        left = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        extr[i, :3, :3] = np.stack([-left, -up, fwd], axis=0)
        extr[i, 3, 3] = 1.0
    return intr, extr


def rig(num_cams: int, hw: Sequence[int]) -> Dict[str, np.ndarray]:
    """The static calibration of one rig at batch 1."""
    intr, extr = ring_cameras(num_cams, hw[0], hw[1])
    lidar2img = np.einsum('nij,njk->nik', intr, extr)
    return dict(lidar2img=lidar2img[None].astype(np.float32),
                intrinsics=intr[None], extrinsics=extr[None])


def image_pool(n: int, num_cams: int, hw: Sequence[int], seed: int,
               device) -> torch.Tensor:
    """(n, 1, num_cams, H, W, 3) uint8 frames drawn on `device`, then moved
    to pinned host memory."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    pool = torch.randint(0, 256, (n, 1, num_cams, hw[0], hw[1], 3),
                         generator=gen, device=device, dtype=torch.uint8)
    return pinned(pool.cpu(), device)


def pinned(x: torch.Tensor, device) -> torch.Tensor:
    """`x` in pinned host memory when it is bound for a card."""
    return x.pin_memory() if torch.device(device).type == 'cuda' else x


class Stream:
    """The frames of one rig's stream: ``frame(i)`` is the i-th frame's
    pool index and its per-frame inputs (host numpy)."""

    def __init__(self, traffic: Dict, seed: int):
        self.t = traffic
        rng = np.random.default_rng(sub_seed(seed, 2))
        self.order = rng.permutation(traffic['pool_frames'])
        self.seed = seed
        self._scenes: Dict[int, tuple] = {}

    def _scene(self, s: int):
        if s not in self._scenes:
            r = np.random.default_rng(sub_seed(self.seed, 1000 + s))
            lo, hi = self.t['speed_mps']
            ylo, yhi = self.t['yaw_rate_dps']
            self._scenes[s] = (r.uniform(-500, 500, 2), r.uniform(-np.pi, np.pi),
                               r.uniform(lo, hi), np.radians(r.uniform(ylo, yhi)))
        return self._scenes[s]

    def frame(self, i: int) -> Dict:
        n = self.t['scene_frames']
        s, j = divmod(i, n)
        (x0, y0), yaw0, v, w = self._scene(s)
        t = j * self.t['frame_dt_s']
        yaw = yaw0 + w * t
        if abs(w) > 1e-9:
            x = x0 + v / w * (math.sin(yaw) - math.sin(yaw0))
            y = y0 - v / w * (math.cos(yaw) - math.cos(yaw0))
        else:
            x, y = x0 + v * t * math.cos(yaw0), y0 + v * t * math.sin(yaw0)
        pose = np.eye(4)
        pose[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                        [math.sin(yaw), math.cos(yaw)]]
        pose[:2, 3] = (x, y)
        return dict(pool=int(self.order[i % len(self.order)]),
                    prev_exists=np.float32(j > 0),
                    timestamp=np.float32(t),
                    ego_pose=pose.astype(np.float32),
                    ego_pose_inv=np.linalg.inv(pose).astype(np.float32))


def check_frames(traffic: Dict, seed: int) -> List[int]:
    """The frames whose outputs the run compares with the reference: the
    first, the first of the second scene where it lies within
    ``check_within``, and a seeded draw of the rest."""
    within, n = traffic['check_within'], traffic['check_frames']
    fixed = [0] + ([traffic['scene_frames']]
                   if traffic['scene_frames'] < within else [])
    rng = np.random.default_rng(sub_seed(seed, 3))
    rest = rng.choice(np.setdiff1d(np.arange(1, within), fixed),
                      n - len(fixed), replace=False)
    return sorted(fixed + [int(i) for i in rest])


def train_batches(host_cfg, traffic: Dict, seed: int,
                  device) -> List[Dict[str, torch.Tensor]]:
    """``pool_batches`` synthetic training batches (host, pinned), the
    images uint8."""
    out = []
    for k in range(traffic['pool_batches']):
        b = synthetic_batch(host_cfg, 1, sub_seed(seed, 100 + k))
        b['images'] = image_pool(1, host_cfg.data.num_cams,
                                 host_cfg.data.input_hw,
                                 sub_seed(seed, 200 + k), device)[0]
        out.append({k2: pinned(v, device) for k2, v in b.items()})
    return out


def synthetic_batch(cfg, batch: int, seed: int) -> Dict[str, torch.Tensor]:
    """One training frame per batch lane without images: up to max_gt
    random boxes in the pc range; for each camera the 2D boxes, centers
    and labels of the GT centers it sees, and their LID depth bins painted
    on the stride-8 grid (the port's ``synthetic_batch``, copied)."""
    rng = np.random.RandomState(seed)
    n = cfg.data.num_cams
    h, w = cfg.data.input_hw
    g = cfg.data.max_gt
    g2 = cfg.data.max_gt_2d
    dcfg = cfg.depthnet
    h8, w8 = h // dcfg.stride, w // dcfg.stride

    intr, extr = ring_cameras(n, h, w)
    lidar2img = np.einsum('nij,njk->nik', intr, extr)
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
                idx = -0.5 + 0.5 * np.sqrt(1 + 8 * (uvd[2] - dcfg.depth_min) / bs)
                idx = int(np.clip(idx, 0, dcfg.num_depth_bins))
                box = gt_boxes2d[b, cam, cnt]
                u8a, v8a = int(box[0] // 8), int(box[1] // 8)
                u8b, v8b = int(np.ceil(box[2] / 8)), int(np.ceil(box[3] / 8))
                for vv in range(max(v8a, 0), min(v8b, h8)):
                    row = slice(vv * w8 + max(u8a, 0), vv * w8 + min(u8b, w8))
                    depth_bins[b, cam, row] = idx
                    depth_fg[b, cam, row] = True
                cnt += 1

    eye = np.tile(np.eye(4, dtype=np.float32)[None], (batch, 1, 1))
    data = dict(
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
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in data.items()}
