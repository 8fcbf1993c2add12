"""Devkit-free nuScenes info-pkl generation (the twin of
``tools/create_nusc_infos.py``, without jax: JSON and numpy only).

Reference: tools/create_data_nusc.py + tools/data_converter/
nuscenes_converter.py:1-708 (which require the nuscenes devkit). This
converter reads the raw nuScenes relational JSON tables directly
({version}/sample.json, sample_data.json, calibrated_sensor.json,
ego_pose.json, sensor.json, scene.json, sample_annotation.json,
instance.json, category.json) and emits the StreamPETR-style temporal info
pkl consumed by ``data/nuscenes_dataset.py`` (the port's and the JAX
package's):

per keyframe: timestamp, scene_token, lidar2ego_*/ego2global_* (LIDAR_TOP),
cams {channel: data_path, cam_intrinsic, sensor2lidar_rotation/translation,
timestamp}, gt_boxes (M, 9) [x, y, z_bottom, w, l, h, yaw, vx, vy] in the
lidar frame with the mmdet3d yaw convention (-yaw_lidar - pi/2,
nuscenes_converter.py gt_boxes assembly), gt_names, gt_attrs (annotation
attribute names, for the AAE metric), valid_flag
(num_lidar_pts + num_radar_pts > 0), and projected 2D annotations per camera
(the devkit-free equivalent of export_2d_annotation: 3D corners projected
through lidar2cam, clipped xyxy + projected centers + center depths).

    python -m far3d_tpu_torch.cli.create_nusc_infos \
        --data-root data/nuscenes --version v1.0-mini --split mini_train \
        --out nusc_infos_train.pkl
"""

from __future__ import annotations

import argparse
import json
import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..data.nuscenes_dataset import NUSC_CLASSES

CAM_CHANNELS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT',
                'CAM_BACK', 'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')

# nuScenes detection-category mapping (nuscenes_converter.py NameMapping)
NAME_MAP = {
    'movable_object.barrier': 'barrier',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.car': 'car',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.motorcycle': 'motorcycle',
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'movable_object.trafficcone': 'traffic_cone',
    'vehicle.trailer': 'trailer',
    'vehicle.truck': 'truck',
}

# v1.0-mini split scene names (nuscenes devkit splits.py; small enough to
# embed — full-split users pass --scene-list)
MINI_TRAIN = ['scene-0061', 'scene-0553', 'scene-0655', 'scene-0757',
              'scene-0796', 'scene-1077', 'scene-1094', 'scene-1100']
MINI_VAL = ['scene-0103', 'scene-0916']


def quat_to_rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def rt_to_mat(rotation_q, translation):
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(np.asarray(rotation_q, np.float64))
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def load_tables(data_root: Path, version: str):
    tables = {}
    for name in ('sample', 'sample_data', 'calibrated_sensor', 'ego_pose',
                 'sensor', 'scene', 'sample_annotation', 'instance',
                 'category', 'attribute'):
        path = data_root / version / f'{name}.json'
        if name == 'attribute' and not path.exists():
            tables[name] = {}
            continue
        with open(path) as f:
            rows = json.load(f)
        tables[name] = {r['token']: r for r in rows}
    return tables


def corners_3d(box):
    """(7,) [x, y, z_bottom, w, l, h, yaw(nuScenes lidar)] -> (8, 3)."""
    x, y, zb, w, l, h, yaw = box[:7]
    xs = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
    ys = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
    zs = np.array([0, 0, 0, 0, 1, 1, 1, 1]) * h
    rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                    [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    pts = rot @ np.stack([xs, ys, zs])
    return (pts + np.array([[x], [y], [zb]])).T


def project_boxes_2d(boxes_lidar, centers_lidar, labels, lidar2cam, intr,
                     img_wh):
    """Devkit-free export_2d_annotation: clipped xyxy from projected
    corners + projected gravity centers + center depths."""
    w_img, h_img = img_wh
    bboxes, labs, centers, depths = [], [], [], []
    for bi in range(len(boxes_lidar)):
        cor = corners_3d(boxes_lidar[bi])
        cam = (lidar2cam[:3, :3] @ cor.T + lidar2cam[:3, 3:4])
        if (cam[2] < 0.1).all():
            continue
        vis = cam[:, cam[2] > 0.1]
        uv = (intr[:3, :3] @ vis)
        uv = uv[:2] / uv[2:3]
        x0, y0 = uv.min(axis=1)
        x1, y1 = uv.max(axis=1)
        x0, x1 = np.clip([x0, x1], 0, w_img - 1)
        y0, y1 = np.clip([y0, y1], 0, h_img - 1)
        if x1 - x0 < 1 or y1 - y0 < 1:
            continue
        ctr_cam = lidar2cam[:3, :3] @ centers_lidar[bi] + lidar2cam[:3, 3]
        if ctr_cam[2] <= 0.1:
            continue
        ctr_uv = intr[:3, :3] @ ctr_cam
        bboxes.append([x0, y0, x1, y1])
        labs.append(labels[bi])
        centers.append([ctr_uv[0] / ctr_uv[2], ctr_uv[1] / ctr_uv[2]])
        depths.append(ctr_cam[2])
    return (np.asarray(bboxes, np.float32).reshape(-1, 4),
            np.asarray(labs, np.int64).reshape(-1),
            np.asarray(centers, np.float32).reshape(-1, 2),
            np.asarray(depths, np.float32).reshape(-1))


def create_nusc_infos(data_root, version, scene_names=None, with_2d=True,
                      img_wh=(1600, 900)):
    data_root = Path(data_root)
    t = load_tables(data_root, version)

    # keyframe sample_data per sample, by channel
    sd_by_sample = defaultdict(dict)
    for sd in t['sample_data'].values():
        if not sd['is_key_frame']:
            continue
        cs = t['calibrated_sensor'][sd['calibrated_sensor_token']]
        channel = t['sensor'][cs['sensor_token']]['channel']
        sd_by_sample[sd['sample_token']][channel] = sd
    anns_by_sample = defaultdict(list)
    for ann in t['sample_annotation'].values():
        anns_by_sample[ann['sample_token']].append(ann)

    infos = []
    for sample in t['sample'].values():
        scene = t['scene'][sample['scene_token']]
        if scene_names is not None and scene['name'] not in scene_names:
            continue
        sds = sd_by_sample[sample['token']]
        if 'LIDAR_TOP' not in sds:
            continue
        lid = sds['LIDAR_TOP']
        lid_cs = t['calibrated_sensor'][lid['calibrated_sensor_token']]
        lid_ep = t['ego_pose'][lid['ego_pose_token']]
        l2e = rt_to_mat(lid_cs['rotation'], lid_cs['translation'])
        e2g = rt_to_mat(lid_ep['rotation'], lid_ep['translation'])
        g2l = np.linalg.inv(e2g @ l2e)       # global -> lidar

        cams = {}
        for ch in CAM_CHANNELS:
            if ch not in sds:
                continue
            sd = sds[ch]
            cs = t['calibrated_sensor'][sd['calibrated_sensor_token']]
            ep = t['ego_pose'][sd['ego_pose_token']]
            cam2global = rt_to_mat(ep['rotation'], ep['translation']) @ \
                rt_to_mat(cs['rotation'], cs['translation'])
            cam2lidar = g2l @ cam2global     # sensor -> lidar at lidar time
            cams[ch] = dict(
                data_path=sd['filename'],
                cam_intrinsic=np.asarray(cs['camera_intrinsic'], np.float64),
                sensor2lidar_rotation=cam2lidar[:3, :3],
                sensor2lidar_translation=cam2lidar[:3, 3],
                timestamp=sd['timestamp'])

        # annotations -> lidar-frame boxes
        boxes9, names, valid, attrs = [], [], [], []
        boxes_raw, centers_l, labels2d_src = [], [], []
        for ann in sorted(anns_by_sample[sample['token']],
                          key=lambda a: a['token']):
            inst = t['instance'][ann['instance_token']]
            cat = t['category'][inst['category_token']]['name']
            if cat not in NAME_MAP:
                continue
            det_name = NAME_MAP[cat]
            ctr_g = np.asarray(ann['translation'], np.float64)
            ctr_l = g2l[:3, :3] @ ctr_g + g2l[:3, 3]
            rot_l = g2l[:3, :3] @ quat_to_rot(
                np.asarray(ann['rotation'], np.float64))
            yaw = float(np.arctan2(rot_l[1, 0], rot_l[0, 0]))
            w_, l_, h_ = ann['size']        # nuScenes size = (w, l, h)
            # velocity: central difference over the instance's track (the
            # devkit's box_velocity), rotated into the lidar frame
            vel = np.zeros(2)
            prev_a = t['sample_annotation'].get(ann['prev'] or '', None)
            next_a = t['sample_annotation'].get(ann['next'] or '', None)
            a0, a1 = prev_a or ann, next_a or ann
            if a0 is not a1:
                t0 = t['sample'][a0['sample_token']]['timestamp']
                t1 = t['sample'][a1['sample_token']]['timestamp']
                dp = (np.asarray(a1['translation'])
                      - np.asarray(a0['translation']))
                v_g = dp / max((t1 - t0) / 1e6, 1e-6)
                vel = (g2l[:3, :3] @ v_g)[:2]
            # mmdet3d yaw convention (nuscenes_converter: -yaw - pi/2)
            boxes9.append([ctr_l[0], ctr_l[1], ctr_l[2] - h_ / 2,
                           w_, l_, h_, -yaw - np.pi / 2, vel[0], vel[1]])
            boxes_raw.append([ctr_l[0], ctr_l[1], ctr_l[2] - h_ / 2,
                              w_, l_, h_, yaw])
            centers_l.append(ctr_l)
            names.append(det_name)
            # devkit/mmdet3d keep GTs visible to lidar OR radar
            valid.append(ann.get('num_lidar_pts', 1)
                         + ann.get('num_radar_pts', 0) > 0)
            at = ann.get('attribute_tokens') or []
            attrs.append(t['attribute'].get(at[0], {}).get('name', '')
                         if at else '')
            labels2d_src.append(NUSC_CLASSES.index(det_name))

        info = dict(
            token=sample['token'],
            scene_token=sample['scene_token'],
            timestamp=sample['timestamp'],
            lidar2ego_rotation=lid_cs['rotation'],
            lidar2ego_translation=lid_cs['translation'],
            ego2global_rotation=lid_ep['rotation'],
            ego2global_translation=lid_ep['translation'],
            cams=cams,
            gt_boxes=np.asarray(boxes9, np.float32).reshape(-1, 9),
            gt_names=np.asarray(names),
            gt_attrs=np.asarray(attrs),    # annotation attribute names
            valid_flag=np.asarray(valid, bool),
        )
        if with_2d and cams:
            an2 = dict(bboxes2d=[], labels2d=[], centers2d=[], depths=[])
            for ch, ci in cams.items():
                r = np.asarray(ci['sensor2lidar_rotation'])
                tr = np.asarray(ci['sensor2lidar_translation'])
                lidar2cam = np.eye(4)
                lidar2cam[:3, :3] = r.T
                lidar2cam[:3, 3] = -r.T @ tr
                intr = np.eye(4)
                k = ci['cam_intrinsic']
                intr[:k.shape[0], :k.shape[1]] = k
                bb, ll, cc, dd = project_boxes_2d(
                    np.asarray(boxes_raw, np.float64).reshape(-1, 7),
                    np.asarray(centers_l, np.float64).reshape(-1, 3),
                    np.asarray(labels2d_src, np.int64),
                    lidar2cam, intr, img_wh)
                an2['bboxes2d'].append(bb)
                an2['labels2d'].append(ll)
                an2['centers2d'].append(cc)
                an2['depths'].append(dd)
            info['annos'] = an2
        infos.append(info)

    infos.sort(key=lambda e: e['timestamp'])
    return infos


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--version', default='v1.0-mini')
    p.add_argument('--split', default=None,
                   choices=[None, 'mini_train', 'mini_val'],
                   help='built-in v1.0-mini splits')
    p.add_argument('--scene-list', default=None,
                   help='file with one scene name per line (full splits)')
    p.add_argument('--out', required=True)
    p.add_argument('--no-2d', action='store_true')
    args = p.parse_args(argv)

    scene_names = None
    if args.split == 'mini_train':
        scene_names = set(MINI_TRAIN)
    elif args.split == 'mini_val':
        scene_names = set(MINI_VAL)
    if args.scene_list:
        with open(args.scene_list) as f:
            scene_names = {ln.strip() for ln in f if ln.strip()}

    infos = create_nusc_infos(args.data_root, args.version, scene_names,
                              with_2d=not args.no_2d)
    with open(args.out, 'wb') as f:
        pickle.dump({'infos': infos,
                     'metadata': {'version': args.version}}, f)
    print(f'wrote {len(infos)} infos to {args.out}')


if __name__ == '__main__':
    main()
