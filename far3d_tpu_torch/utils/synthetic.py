"""Seeded synthetic inputs (plain numpy; counterpart of
``far3d_tpu/utils/synthetic.py``'s ``ring_cameras``, ``synthetic_batch`` and
the learnable dataset writers): pinhole cameras in a ring, random normalized
images, for training random GT boxes with their 2D boxes and painted depth
bins, on-disk AV2-format datasets whose images encode their labels, and
their StreamPETR / nuScenes counterparts.

The writers draw what the JAX package's draw, in the same order from the
same ``np.random.RandomState``, and write the same infos; the images are PNG
(``data/image_io.py``) in place of JPEG, with the same filled circles."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Far3DConfig
from ..data.image_io import fill_circle, write_png


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


def make_learnable_dataset(info_path: str, root: str, n_scenes: int = 2,
                           frames_per_scene: int = 8, seed: int = 0,
                           src_hw=(128, 192), n_boxes: int = 4):
    """On-disk AV2-format dataset whose images *encode* the labels: bright
    blobs at the projected GT box centers, blob size ~ box size / depth.
    Built for the closed-loop train->eval demonstration (the reference's only
    QC is the end-to-end metric check, SURVEY §4): a correct train / decode /
    match / metric stack must overfit it to near-perfect mAP.

    Two cameras (forward +x / backward -x), static boxes per scene in the
    city frame, ego translating +x each frame. Box geometry sits inside the
    tiny test pc-range (xy within ±10 m, z in [1, 3]).
    """
    import os
    import pickle

    rng = np.random.RandomState(seed)
    sh, sw = src_hw
    f = 150.0
    cx, cy = sw / 2.0, sh / 2.0
    intr3 = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    # cam->ego rotations: columns = camera x (right), y (down), z (forward)
    # expressed in ego axes (x fwd, y left, z up). NOTE: an erroneous .T here
    # (fixed round 4) used to flip these to ego->cam, which put every box
    # behind the cameras — no blob was ever drawn and the closed loop was
    # learnable only through scene/time memorization. The nuScenes twin
    # (make_learnable_nusc_dataset) always had the correct orientation.
    r_fwd = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    r_back = np.array([[0.0, 0, -1], [1, 0, 0], [0, -1, 0]])
    cam_rots = [r_fwd, r_back]
    cam_t = np.array([0.0, 0.0, 1.5])

    class_ids = [15, 5, 20]        # REGULAR_VEHICLE, BUS, TRUCK
    colors = [(60, 220, 60), (220, 60, 60), (60, 60, 220)]

    infos = []
    os_root = root
    for s in range(n_scenes):
        # static scene: boxes in the city frame, split between both cameras,
        # placed so every box stays inside a camera frustum (half-FOV 32.6
        # deg at f=150) for ALL frames incl. the ego's +x drift — an
        # invisible GT still counts in the recall denominator and caps mAP.
        # y slots keep blobs separated so the 3x3 local-max NMS can't merge.
        sgn = np.where(np.arange(n_boxes) % 2 == 0, 1.0, -1.0)
        y_slots = np.linspace(-1.5, 1.5, n_boxes)
        city_boxes = np.stack([
            sgn * rng.uniform(7.0, 9.5, n_boxes),       # x ahead/behind
            y_slots + rng.uniform(-0.3, 0.3, n_boxes),  # y
            rng.uniform(1.0, 2.5, n_boxes),             # z
            rng.uniform(0.8, 1.6, n_boxes),             # w
            rng.uniform(0.8, 1.6, n_boxes),             # l
            rng.uniform(0.8, 1.5, n_boxes),             # h
            rng.uniform(-np.pi, np.pi, n_boxes),        # yaw
        ], axis=1)
        # per-box constant velocities (city frame): boxes MOVE, so a model
        # that memorizes time-averaged positions instead of reading the
        # image pays ~1 m ATE — forces image-grounded localization
        # magnitudes chosen so worst-case (box y + motion) stays inside the
        # 32.6 deg half-FOV across all frames: max angle ~30 deg
        vel = np.stack([sgn * rng.uniform(-0.15, 0.15, n_boxes),
                        rng.uniform(-0.45, 0.45, n_boxes),
                        np.zeros(n_boxes)], axis=1)
        dt = 0.5
        labels = rng.choice(len(class_ids), n_boxes)
        for fi in range(frames_per_scene):
            ego = np.eye(4)
            ego[0, 3] = fi * 0.1                         # ego moves +x
            city_boxes = city_boxes.copy()
            city_boxes[:, :3] = city_boxes[:, :3] if fi == 0 else \
                city_boxes[:, :3] + vel * dt
            ego_inv = np.linalg.inv(ego)
            # boxes in the ego frame of this timestamp
            ego_boxes = city_boxes.copy()
            ego_boxes[:, :3] = (ego_inv[:3, :3] @ city_boxes[:, :3].T).T \
                + ego_inv[:3, 3]
            cam_infos = {}
            g2d_boxes, g2d_labels, g2d_centers, g2d_depths = [], [], [], []
            for c in range(2):
                ego_cam = np.eye(4)
                ego_cam[:3, :3] = cam_rots[c]
                ego_cam[:3, 3] = cam_t
                cam_infos[f'cam{c}'] = dict(
                    fpath=f'scene{s}/cam{c}/{fi}.png',
                    intrinsics=intr3.copy(),
                    ego_SE3_cam=ego_cam,
                    city_SE3_ego_cam_t=ego.copy(),
                    cam_timestamp_ns=fi * int(1e8),
                )
                # per-scene background fingerprint: learned queries memorize
                # the UNION of all scenes' boxes; the image must let the
                # model suppress wrong-scene hypotheses or mid-score phantom
                # detections halve AP (observed: plateau at ~0.46 with
                # indistinguishable backgrounds)
                bg = 70 + 60 * (s % 2)
                img = np.full((sh, sw, 3), bg, np.uint8)
                img[:: 8 + 4 * (s % 3), :] = 40
                cam_from_ego = np.linalg.inv(ego_cam)
                bx, lb, ctr, dp = [], [], [], []
                for bi in range(n_boxes):
                    p = cam_from_ego[:3, :3] @ ego_boxes[bi, :3] \
                        + cam_from_ego[:3, 3]
                    if p[2] < 2.0:
                        continue
                    u = f * p[0] / p[2] + cx
                    v = f * p[1] / p[2] + cy
                    if not (8 <= u < sw - 8 and 8 <= v < sh - 8):
                        continue
                    r_px = max(int(f * ego_boxes[bi, 3] / (2 * p[2])), 3)
                    # shade encodes metric depth so the task is fully
                    # observable (depth from blob size alone is weak at the
                    # tiny model's capacity; the demo tests the train/decode/
                    # match/metric stack, not monocular depth perception)
                    shade = float(np.clip(60 + (p[2] - 4.5) * 33.0, 60, 255))
                    color = tuple(c * shade / 255.0
                                  for c in colors[labels[bi]])
                    fill_circle(img, (int(round(u)), int(round(v))), r_px,
                                color)
                    bx.append([max(u - 2 * r_px, 0), max(v - 2 * r_px, 0),
                               min(u + 2 * r_px, sw - 1),
                               min(v + 2 * r_px, sh - 1)])
                    lb.append(class_ids[labels[bi]])
                    ctr.append([u, v])
                    dp.append(p[2])
                g2d_boxes.append(np.asarray(bx, np.float32).reshape(-1, 4))
                g2d_labels.append(np.asarray(lb, np.int64))
                g2d_centers.append(np.asarray(ctr, np.float32).reshape(-1, 2))
                g2d_depths.append(np.asarray(dp, np.float32))
                path = os.path.join(os_root, cam_infos[f'cam{c}']['fpath'])
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_png(path, img)
            infos.append(dict(
                scene_id=f'scene{s}',
                lidar_timestamp_ns=fi * int(1e8),
                city_SE3_ego_lidar_t=ego.copy(),
                cam_infos=cam_infos,
                gt3d_infos=dict(
                    gt_boxes=ego_boxes.astype(np.float32),
                    gt_names=np.array(
                        [Far3DConfig().class_names[class_ids[l]]
                         for l in labels]),
                    num_interior_pts=np.full(n_boxes, 10),
                ),
                gt2d_infos=dict(
                    gt_2dbboxes=g2d_boxes,
                    gt_2dlabels=g2d_labels,
                    centers2d=g2d_centers,
                    depths=g2d_depths,
                ),
            ))
    with open(info_path, 'wb') as fobj:
        pickle.dump({'infos': infos}, fobj)
    return infos


def make_learnable_dataset_fullsize(info_path: str, root: str,
                                    n_scenes: int = 2,
                                    frames_per_scene: int = 8, seed: int = 0,
                                    n_cams: int = 7, boxes_per_cam: int = 2,
                                    depth_range=(12.0, 32.0)):
    """Production-scale twin of `make_learnable_dataset` for the FULL-SIZE
    on-chip closed loop (tools/overfit_full.py): 7 ring cameras at native AV2
    resolutions (portrait 2048x1550 front camera + six landscape 1550x2048,
    f=1700), `boxes_per_cam` car-sized boxes per camera frustum at
    12-32 m, depth encoded in blob shade, class in color, scene identity in
    the background fingerprint. Exercises the real host pipeline (portrait
    pre-rotation, resize/crop, LID depth painting at production bins) and the
    production model shapes end to end.
    """
    import os
    import os
    import pickle

    rng = np.random.RandomState(seed)
    f = 1700.0
    cam_t = np.array([0.0, 0.0, 1.5])
    d_lo, d_hi = depth_range

    class_ids = [15, 5, 20]        # REGULAR_VEHICLE, BUS, TRUCK
    colors = [(60, 220, 60), (220, 60, 60), (60, 60, 220)]

    # ring of cameras; cam 0 is the portrait front camera
    cam_geo = []
    for c in range(n_cams):
        yaw = 2 * np.pi * c / n_cams
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        rot = np.stack([right, down, fwd], axis=1)   # cam->ego columns
        sh, sw = (2048, 1550) if c == 0 else (1550, 2048)
        cam_geo.append((rot, sh, sw, fwd, right))

    infos = []
    for s in range(n_scenes):
        # per-camera boxes: along the camera axis at d in depth_range with a
        # lateral offset well inside the frustum (half-FOV 24.5 deg portrait /
        # 31 deg landscape at f=1700) so ego drift never hides a GT
        boxes, labels = [], []
        for c in range(n_cams):
            _, _, _, fwd, right = cam_geo[c]
            for _ in range(boxes_per_cam):
                d = rng.uniform(d_lo, d_hi)
                lat = rng.uniform(-0.18, 0.18) * d
                ctr = fwd * d + right * lat
                boxes.append([ctr[0], ctr[1], rng.uniform(0.8, 2.2),
                              rng.uniform(1.8, 2.2),    # w
                              rng.uniform(4.0, 5.0),    # l
                              rng.uniform(1.4, 1.8),    # h
                              rng.uniform(-np.pi, np.pi)])
                labels.append(rng.randint(len(class_ids)))
        city_boxes = np.asarray(boxes)
        labels = np.asarray(labels)
        nb = len(city_boxes)
        vel = np.stack([rng.uniform(-0.3, 0.3, nb),
                        rng.uniform(-0.3, 0.3, nb),
                        np.zeros(nb)], axis=1)
        dt = 0.5
        for fi in range(frames_per_scene):
            ego = np.eye(4)
            ego[0, 3] = fi * 0.1
            city_boxes = city_boxes.copy()
            if fi > 0:
                city_boxes[:, :3] = city_boxes[:, :3] + vel * dt
            ego_inv = np.linalg.inv(ego)
            ego_boxes = city_boxes.copy()
            ego_boxes[:, :3] = (ego_inv[:3, :3] @ city_boxes[:, :3].T).T \
                + ego_inv[:3, 3]
            cam_infos = {}
            g2d_boxes, g2d_labels, g2d_centers, g2d_depths = [], [], [], []
            for c in range(n_cams):
                rot, sh, sw, _, _ = cam_geo[c]
                cx, cy = sw / 2.0, sh / 2.0
                intr3 = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
                ego_cam = np.eye(4)
                ego_cam[:3, :3] = rot
                ego_cam[:3, 3] = cam_t
                cam_infos[f'cam{c}'] = dict(
                    fpath=f'scene{s}/cam{c}/{fi}.png',
                    intrinsics=intr3.copy(),
                    ego_SE3_cam=ego_cam,
                    city_SE3_ego_cam_t=ego.copy(),
                    cam_timestamp_ns=fi * int(1e8),
                )
                bg = 70 + 60 * (s % 2)
                img = np.full((sh, sw, 3), bg, np.uint8)
                img[:: 32 + 16 * (s % 3), :] = 40
                cam_from_ego = np.linalg.inv(ego_cam)
                bx, lb, ctr, dp = [], [], [], []
                for bi in range(nb):
                    p = cam_from_ego[:3, :3] @ ego_boxes[bi, :3] \
                        + cam_from_ego[:3, 3]
                    if p[2] < 2.0:
                        continue
                    u = f * p[0] / p[2] + cx
                    v = f * p[1] / p[2] + cy
                    if not (8 <= u < sw - 8 and 8 <= v < sh - 8):
                        continue
                    r_px = int(np.clip(f * ego_boxes[bi, 3] / (2 * p[2]),
                                       6, 160))
                    # shade encodes metric depth over the full depth range
                    shade = float(np.clip(
                        60 + (p[2] - d_lo) * 195.0 / (d_hi - d_lo), 60, 255))
                    color = tuple(col * shade / 255.0
                                  for col in colors[labels[bi]])
                    fill_circle(img, (int(round(u)), int(round(v))), r_px,
                                color)
                    bx.append([max(u - 2 * r_px, 0), max(v - 2 * r_px, 0),
                               min(u + 2 * r_px, sw - 1),
                               min(v + 2 * r_px, sh - 1)])
                    lb.append(class_ids[labels[bi]])
                    ctr.append([u, v])
                    dp.append(p[2])
                g2d_boxes.append(np.asarray(bx, np.float32).reshape(-1, 4))
                g2d_labels.append(np.asarray(lb, np.int64))
                g2d_centers.append(np.asarray(ctr, np.float32).reshape(-1, 2))
                g2d_depths.append(np.asarray(dp, np.float32))
                path = os.path.join(root, cam_infos[f'cam{c}']['fpath'])
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_png(path, img)
            infos.append(dict(
                scene_id=f'scene{s}',
                lidar_timestamp_ns=fi * int(1e8),
                city_SE3_ego_lidar_t=ego.copy(),
                cam_infos=cam_infos,
                gt3d_infos=dict(
                    gt_boxes=ego_boxes.astype(np.float32),
                    gt_names=np.array(
                        [Far3DConfig().class_names[class_ids[l]]
                         for l in labels]),
                    num_interior_pts=np.full(nb, 10),
                ),
                gt2d_infos=dict(
                    gt_2dbboxes=g2d_boxes,
                    gt_2dlabels=g2d_labels,
                    centers2d=g2d_centers,
                    depths=g2d_depths,
                ),
            ))
    with open(info_path, 'wb') as fobj:
        pickle.dump({'infos': infos}, fobj)
    return infos


def petr_host_shim(cfg, max_gt: int = 8) -> Far3DConfig:
    """A Far3DConfig with StreamPETR's geometry (cameras, input size, pc
    range, classes), through which ``inference_inputs`` and
    ``synthetic_batch`` draw StreamPETR's inputs (the shim of
    tests/test_petr_train.py:18-28)."""
    from ..config import DataConfig
    return Far3DConfig(
        pc_range=cfg.pc_range, num_classes=cfg.num_classes,
        data=DataConfig(num_cams=cfg.num_cams, input_hw=tuple(cfg.input_hw),
                        max_gt=max_gt, max_gt_2d=8))


def petr_inference_inputs(cfg, batch: int = 1,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """One frame of StreamPETR inference inputs: ring cameras, random
    normalized images, identity ego pose, a fresh stream."""
    out = inference_inputs(petr_host_shim(cfg), batch, seed)
    del out['intrinsics'], out['extrinsics']
    return out


def petr_synthetic_batch(cfg, batch: int = 1, seed: int = 0,
                         max_gt: int = 8) -> Dict[str, torch.Tensor]:
    """A StreamPETR training batch: ``synthetic_batch`` of the shim, the
    draws of the JAX package's ``synthetic_batch`` of the same shim."""
    return synthetic_batch(petr_host_shim(cfg, max_gt), batch, seed)


def make_learnable_nusc_dataset(info_path: str, root: str, n_scenes: int = 2,
                                frames_per_scene: int = 8, seed: int = 0,
                                src_hw=(64, 96), n_boxes: int = 4,
                                image_format: str = 'png'):
    """nuScenes-format twin of ``make_learnable_dataset`` for the StreamPETR
    closed loop (synthetic.py:342-452): an info pkl in StreamPETR's layout
    and blob images whose appearance encodes the GT (position by
    projection, depth by shade, class by colour, scene by background).

    Geometry inside ``tiny_petr_config``'s pc range; two cameras
    (CAM_FRONT +x, CAM_BACK -x), lidar2ego the identity, the ego moving +x,
    constant global velocities per box; boxes stored 9-dim (x, y,
    z_bottom, w, l, h, yaw, vx, vy) as the StreamPETR infos carry them.
    The draws are the JAX writer's; the images are PNG with the same
    filled circles, or with `image_format` 'jpg' the JAX writer's JPEG
    files (``cv2.imwrite``; OpenCV must be installed)."""
    import os
    import pickle

    if image_format == 'jpg':
        import cv2
        write = cv2.imwrite
    elif image_format == 'png':
        write = write_png
    else:
        raise ValueError(f'image_format {image_format!r}: png or jpg')

    rng = np.random.RandomState(seed)
    sh, sw = src_hw
    f = sw * 150.0 / 192.0
    cx, cy = sw / 2.0, sh / 2.0
    intr3 = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    # sensor2lidar rotations: columns = camera axes (x right, y down, z fwd)
    # in the lidar / ego frame (x fwd, y left, z up)
    r_fwd = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    r_back = np.array([[0.0, 0, -1], [1, 0, 0], [0, -1, 0]])
    cam_rots = [r_fwd, r_back]
    cam_t = np.array([0.0, 0.0, 1.5])
    ident_q = np.array([1.0, 0, 0, 0])

    class_names = ['car', 'truck', 'bus']        # NUSC_CLASSES 0 / 1 / 3
    colors = [(60, 220, 60), (220, 60, 60), (60, 60, 220)]

    infos = []
    for s in range(n_scenes):
        sgn = np.where(np.arange(n_boxes) % 2 == 0, 1.0, -1.0)
        y_slots = np.linspace(-1.5, 1.5, n_boxes)
        glob = np.stack([
            sgn * rng.uniform(7.0, 9.5, n_boxes),
            y_slots + rng.uniform(-0.3, 0.3, n_boxes),
            rng.uniform(1.0, 2.5, n_boxes),
            rng.uniform(0.8, 1.6, n_boxes),              # w
            rng.uniform(0.8, 1.6, n_boxes),              # l
            rng.uniform(0.8, 1.5, n_boxes),              # h
            rng.uniform(-np.pi, np.pi, n_boxes),         # yaw
        ], axis=1)
        vel = np.stack([sgn * rng.uniform(-0.15, 0.15, n_boxes),
                        rng.uniform(-0.45, 0.45, n_boxes)], axis=1)
        dt = 0.5
        labels = rng.choice(len(class_names), n_boxes)
        for fi in range(frames_per_scene):
            ego_t = np.array([fi * 0.1, 0.0, 0.0])
            if fi > 0:
                glob = glob.copy()
                glob[:, :2] = glob[:, :2] + vel * dt
            ego_boxes = glob.copy()
            ego_boxes[:, :3] -= ego_t
            cams = {}
            for c, cam_name in enumerate(['CAM_FRONT', 'CAM_BACK']):
                bg = 70 + 60 * (s % 2)
                img = np.full((sh, sw, 3), bg, np.uint8)
                img[:: 8 + 4 * (s % 3), :] = 40
                lidar_from_cam_r, lidar_from_cam_t = cam_rots[c], cam_t
                cam_from_lidar_r = lidar_from_cam_r.T
                for bi in range(n_boxes):
                    p = cam_from_lidar_r @ (ego_boxes[bi, :3]
                                            - lidar_from_cam_t)
                    if p[2] < 2.0:
                        continue
                    u = f * p[0] / p[2] + cx
                    v = f * p[1] / p[2] + cy
                    if not (4 <= u < sw - 4 and 4 <= v < sh - 4):
                        continue
                    r_px = max(int(f * ego_boxes[bi, 3] / (2 * p[2])), 2)
                    shade = float(np.clip(60 + (p[2] - 4.5) * 33.0, 60, 255))
                    color = tuple(ch * shade / 255.0
                                  for ch in colors[labels[bi]])
                    fill_circle(img, (int(round(u)), int(round(v))), r_px,
                                color)
                cams[cam_name] = dict(
                    data_path=f'scene{s}/{cam_name}/{fi}.{image_format}',
                    cam_intrinsic=intr3.copy(),
                    sensor2lidar_rotation=lidar_from_cam_r.copy(),
                    sensor2lidar_translation=lidar_from_cam_t.copy(),
                )
                path = os.path.join(root, cams[cam_name]['data_path'])
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write(path, img)
            boxes9 = np.concatenate([ego_boxes, vel], axis=1).astype(
                np.float32)
            boxes9[:, 2] -= boxes9[:, 5] / 2          # gravity -> bottom z
            infos.append(dict(
                scene_token=f'scene{s}',
                timestamp=int((s * frames_per_scene + fi) * dt * 1e6),
                lidar2ego_rotation=ident_q.copy(),
                lidar2ego_translation=np.zeros(3),
                ego2global_rotation=ident_q.copy(),
                ego2global_translation=ego_t.copy(),
                cams=cams,
                gt_boxes=boxes9,
                gt_names=np.array([class_names[lb] for lb in labels]),
                valid_flag=np.ones(n_boxes, bool),
            ))
    with open(info_path, 'wb') as fobj:
        pickle.dump({'infos': infos}, fobj)
    return infos
