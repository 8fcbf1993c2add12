"""Generate `av2_{split}_infos.pkl` from a raw Argoverse 2 sensor dataset
(the twin of ``tools/create_av2_infos.py``, without jax or pandas).

Self-contained re-implementation of the reference converter
(tools/create_infos_av2/create_av2_infos.py:38-114 + gather_argo2_anno_feather.py)
that reads the logs' Feather tables with ``utils/feather.py:read_feather``
(uncompressed or LZ4, as pyarrow writes them), no av2 devkit, pandas or
pyarrow required. Per lidar sweep it stores:
scene_id, lidar timestamp, city_SE3_ego at lidar time, per-camera closest
image path + intrinsics + extrinsics + ego pose at camera time, 3D cuboids
(gravity-center xyz + lwh + yaw, category, num_interior_pts) and their
per-camera 2D projections (boxes, centers, depths).

    python -m far3d_tpu_torch.cli.create_av2_infos --data-root data/av2 \
        --split val

A table is a dict of column arrays here; where the JAX tool sorts, filters
and takes rows of a DataFrame, this one does the same with numpy (``_take``,
``_first``), with a stable sort where pandas' default sort is not.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ..config import AV2_CLASS_NAMES
from ..utils.feather import read_feather

RING_CAMERAS = (
    'ring_front_center', 'ring_front_left', 'ring_front_right',
    'ring_rear_left', 'ring_rear_right', 'ring_side_left', 'ring_side_right')

# max timestamp gap between lidar sweep and camera frame (cams run 20 Hz)
MAX_CAM_LIDAR_DELTA_NS = int(55e6)


def quat_to_mat(qw, qx, qy, qz):
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]])


def row_to_se3(row):
    m = np.eye(4)
    m[:3, :3] = quat_to_mat(row['qw'], row['qx'], row['qy'], row['qz'])
    m[:3, 3] = [row['tx_m'], row['ty_m'], row['tz_m']]
    return m


def box_corners_ego(box7):
    """(7,) gravity-center box -> (8, 3) corners in ego frame."""
    x, y, z, l, w, h, yaw = box7
    dx, dy, dz = l / 2, w / 2, h / 2
    corners = np.array([[sx * dx, sy * dy, sz * dz]
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return corners @ rot.T + np.array([x, y, z])


def project_boxes_2d(boxes7, lidar2img, img_hw):
    """Project 3D cuboids into one camera; returns 2D xyxy boxes, centers,
    depths, and the indices of the kept input boxes."""
    h, w = img_hw
    out_boxes, out_centers, out_depths, out_idx = [], [], [], []
    for bi, b in enumerate(boxes7):
        corners = box_corners_ego(b)
        pts = np.concatenate([corners, np.ones((8, 1))], axis=1) @ lidar2img.T
        depth = pts[:, 2]
        if (depth <= 0.1).all():
            continue
        uv = pts[:, :2] / np.maximum(depth[:, None], 1e-5)
        ctr = np.concatenate([b[:3], [1.0]]) @ lidar2img.T
        if ctr[2] <= 0.1:
            continue
        cu, cv = ctr[0] / ctr[2], ctr[1] / ctr[2]
        vis = depth > 0.1
        u = uv[vis, 0]
        v = uv[vis, 1]
        x0, y0 = np.clip(u.min(), 0, w), np.clip(v.min(), 0, h)
        x1, y1 = np.clip(u.max(), 0, w), np.clip(v.max(), 0, h)
        if x1 - x0 < 2 or y1 - y0 < 2 or not (0 <= cu < w and 0 <= cv < h):
            continue
        out_boxes.append([x0, y0, x1, y1])
        out_centers.append([cu, cv])
        out_depths.append(float(ctr[2]))
        out_idx.append(bi)
    return (np.asarray(out_boxes, np.float32).reshape(-1, 4),
            np.asarray(out_centers, np.float32).reshape(-1, 2),
            np.asarray(out_depths, np.float32).reshape(-1),
            np.asarray(out_idx, np.int64))


def _take(table, index):
    """The rows `index` (indices or a boolean mask) of a column table."""
    return {k: v[index] for k, v in table.items()}


def _first(table, column, value):
    """The first row of `table` whose `column` equals `value`, as a dict of
    scalars (``df[df[column] == value].iloc[0]``)."""
    i = np.flatnonzero(table[column] == value)[0]
    return {k: v[i] for k, v in table.items()}


def process_log(log_dir: Path, data_root: Path, with_2d: bool = True):
    scene_id = log_dir.name
    poses = read_feather(log_dir / 'city_SE3_egovehicle.feather')
    poses = _take(poses, np.argsort(poses['timestamp_ns'], kind='stable'))
    pose_ts = poses['timestamp_ns']

    def pose_at(ts):
        i = int(np.argmin(np.abs(pose_ts - ts)))
        return row_to_se3({k: v[i] for k, v in poses.items()})

    calib = read_feather(
        log_dir / 'calibration' / 'egovehicle_SE3_sensor.feather')
    intr = read_feather(log_dir / 'calibration' / 'intrinsics.feather')
    ann_path = log_dir / 'annotations.feather'
    anns = read_feather(ann_path) if ann_path.exists() else None

    cam_files = {}
    for cam in RING_CAMERAS:
        d = log_dir / 'sensors' / 'cameras' / cam
        if not d.exists():
            return []
        ts = sorted(int(p.stem) for p in d.glob('*.jpg'))
        cam_files[cam] = np.asarray(ts, np.int64)

    cam_calib = {}
    for cam in RING_CAMERAS:
        crow = _first(calib, 'sensor_name', cam)
        irow = _first(intr, 'sensor_name', cam)
        k = np.array([[irow['fx_px'], 0, irow['cx_px']],
                      [0, irow['fy_px'], irow['cy_px']], [0, 0, 1.0]])
        hw = (int(irow['height_px']), int(irow['width_px']))
        cam_calib[cam] = (row_to_se3(crow), k, hw)

    lidar_dir = log_dir / 'sensors' / 'lidar'
    infos = []
    for sweep in sorted(lidar_dir.glob('*.feather')):
        ts = int(sweep.stem)
        ego_lidar = pose_at(ts)
        cam_infos = {}
        ok = True
        for cam in RING_CAMERAS:
            files = cam_files[cam]
            j = int(np.argmin(np.abs(files - ts)))
            if abs(int(files[j]) - ts) > MAX_CAM_LIDAR_DELTA_NS:
                ok = False
                break
            cam_ts = int(files[j])
            ego_cam, k, hw = cam_calib[cam]
            cam_infos[cam] = dict(
                fpath=str((log_dir / 'sensors' / 'cameras' / cam /
                           f'{cam_ts}.jpg').relative_to(data_root)),
                cam_timestamp_ns=cam_ts,
                intrinsics=k,
                ego_SE3_cam=ego_cam,
                city_SE3_ego_cam_t=pose_at(cam_ts),
                img_hw=hw,
            )
        if not ok:
            continue

        gt3d = dict(gt_boxes=np.zeros((0, 7), np.float32),
                    gt_names=np.zeros((0,), object),
                    num_interior_pts=np.zeros((0,), np.int64))
        gt2d = dict(gt_2dbboxes=[], gt_2dlabels=[], centers2d=[], depths=[])
        if anns is not None:
            sel = _take(anns, anns['timestamp_ns'] == ts)
            if len(sel['timestamp_ns']):
                q = np.stack([sel[k] for k in ('qw', 'qx', 'qy', 'qz')],
                             axis=1)
                yaw = np.arctan2(
                    2 * (q[:, 0] * q[:, 3] + q[:, 1] * q[:, 2]),
                    1 - 2 * (q[:, 2] ** 2 + q[:, 3] ** 2))
                boxes = np.stack([
                    sel['tx_m'], sel['ty_m'], sel['tz_m'], sel['length_m'],
                    sel['width_m'], sel['height_m'], yaw],
                    axis=1).astype(np.float32)
                gt3d = dict(gt_boxes=boxes, gt_names=sel['category'],
                            num_interior_pts=sel['num_interior_pts'])
            if with_2d:
                names = list(AV2_CLASS_NAMES)
                labels_all = np.array([
                    names.index(nm) if nm in names else -1
                    for nm in gt3d['gt_names']])
                for cam in RING_CAMERAS:
                    ci = cam_infos[cam]
                    ego2cam = (np.linalg.inv(ci['ego_SE3_cam']) @
                               np.linalg.inv(ci['city_SE3_ego_cam_t']) @
                               ego_lidar)
                    viewpad = np.eye(4)
                    viewpad[:3, :3] = ci['intrinsics']
                    l2i = viewpad @ ego2cam
                    # sort far->near so nearer boxes overwrite in depth maps
                    order = np.argsort(-np.linalg.norm(
                        gt3d['gt_boxes'][:, :2], axis=1)) \
                        if len(gt3d['gt_boxes']) else np.zeros(0, int)
                    bsorted = gt3d['gt_boxes'][order]
                    lsorted = labels_all[order]
                    bb, cc, dd, kept = project_boxes_2d(
                        bsorted, l2i, ci['img_hw'])
                    gt2d['gt_2dbboxes'].append(bb)
                    gt2d['gt_2dlabels'].append(lsorted[kept]
                                               if len(kept) else
                                               np.zeros((0,), np.int64))
                    gt2d['centers2d'].append(cc)
                    gt2d['depths'].append(dd)

        infos.append(dict(
            scene_id=scene_id,
            lidar_timestamp_ns=ts,
            city_SE3_ego_lidar_t=ego_lidar,
            cam_infos=cam_infos,
            gt3d_infos=gt3d,
            gt2d_infos=gt2d,
        ))
    return infos


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--split', default='val',
                   choices=['train', 'val', 'test'])
    p.add_argument('--out', default=None)
    p.add_argument('--max-logs', type=int, default=None)
    args = p.parse_args(argv)

    data_root = Path(args.data_root)
    split_dir = data_root / args.split
    logs = sorted(d for d in split_dir.iterdir() if d.is_dir())
    if args.max_logs:
        logs = logs[:args.max_logs]
    infos = []
    for i, log_dir in enumerate(logs):
        infos.extend(process_log(log_dir, data_root,
                                 with_2d=args.split != 'test'))
        print(f'[{i + 1}/{len(logs)}] {log_dir.name}: total {len(infos)}')
    out = args.out or str(data_root / f'av2_{args.split}_infos.pkl')
    with open(out, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    print(f'wrote {len(infos)} frames to {out}')


if __name__ == '__main__':
    main()
