"""nuScenes temporal dataset (a copy of ``far3d_tpu/data/nuscenes_dataset.py``;
reference datasets/nuscenes_dataset.py, CustomNuScenesDataset, the
StreamPETR-lineage twin of the AV2 dataset).

Reads StreamPETR-style `nuscenes2d_temporal_infos_{split}.pkl`: per frame
'cams' {name -> data_path, cam_intrinsic, sensor2lidar_rotation/translation},
'ego2global_*', 'lidar2ego_*', gt_boxes (M, 7 or 9), gt_names, valid_flag.
Produces the same frame records as AV2SequenceDataset.get_frame, so the
port's pipeline (``data/pipeline.py``, images through ``image_io.read_image``),
loaders and runner serve it unchanged.
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

NUSC_CLASSES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                'traffic_cone')


def _rt_to_mat(rotation, translation) -> np.ndarray:
    m = np.eye(4)
    r = np.asarray(rotation)
    if r.shape == (4,):  # quaternion wxyz
        w, x, y, z = r
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    m[:3, :3] = r
    m[:3, 3] = np.asarray(translation)
    return m


class NuScenesSequenceDataset:
    def __init__(self, ann_file: str, data_root: str,
                 classes: Sequence[str] = NUSC_CLASSES,
                 load_interval: int = 1, seq_split_num: int = 1,
                 test_mode: bool = False):
        self.data_root = Path(data_root)
        self.classes = list(classes)
        self.test_mode = test_mode
        with open(ann_file, 'rb') as f:
            data = pickle.load(f)
        infos = sorted(data['infos'], key=lambda e: e['timestamp'])
        self.infos = infos[::load_interval]
        self.seq_split_num = seq_split_num
        self._set_group_flags()

    def _set_group_flags(self):
        flags, scene, cur = [], None, -1
        for info in self.infos:
            tok = info.get('scene_token', info.get('scene_idx'))
            if tok != scene:
                scene = tok
                cur += 1
            flags.append(cur)
        flags = np.asarray(flags, np.int64)
        if self.seq_split_num != 1 and not self.test_mode:
            counts = np.bincount(flags)
            new_flags, nf = [], 0
            for c in counts:
                step = math.ceil(c / self.seq_split_num)
                bounds = list(range(0, c, step)) + [c]
                for ln in np.diff(bounds):
                    new_flags.extend([nf] * int(ln))
                    nf += 1
            flags = np.asarray(new_flags, np.int64)
        self.flag = flags

    def __len__(self):
        return len(self.infos)

    def get_frame(self, index: int) -> Optional[Dict]:
        info = self.infos[index]
        l2e = _rt_to_mat(info['lidar2ego_rotation'],
                         info['lidar2ego_translation'])
        e2g = _rt_to_mat(info['ego2global_rotation'],
                         info['ego2global_translation'])
        ego_pose = (e2g @ l2e).astype(np.float32)   # lidar frame -> global
        rec = dict(
            index=index,
            scene_token=info.get('scene_token', info.get('scene_idx')),
            lidar_timestamp=int(info['timestamp']),
            timestamp=float(index),
            ego_pose=ego_pose,
            ego_pose_inv=np.linalg.inv(ego_pose).astype(np.float32),
            prev_exists=float(not (index == 0 or
                                   self.flag[index - 1] != self.flag[index])),
        )
        paths, l2i, intr, extr = [], [], [], []
        for cam, ci in info['cams'].items():
            lidar2cam = np.eye(4)
            r = np.asarray(ci['sensor2lidar_rotation'])
            t = np.asarray(ci['sensor2lidar_translation'])
            lidar2cam[:3, :3] = r.T
            lidar2cam[:3, 3] = -r.T @ t
            viewpad = np.eye(4)
            k = np.asarray(ci['cam_intrinsic'])
            viewpad[:k.shape[0], :k.shape[1]] = k
            paths.append(str(self.data_root / str(ci['data_path'])))
            intr.append(viewpad)
            extr.append(lidar2cam)
            l2i.append(viewpad @ lidar2cam)
        rec.update(img_paths=paths,
                   lidar2img=np.asarray(l2i, np.float32),
                   intrinsics=np.asarray(intr, np.float32),
                   extrinsics=np.asarray(extr, np.float32))
        if not self.test_mode and 'gt_boxes' in info:
            boxes = np.asarray(info['gt_boxes'], np.float32)
            names = np.asarray(info['gt_names'])
            valid = np.asarray(info.get('valid_flag',
                                        np.ones(len(boxes), bool)))
            labels = np.asarray([
                self.classes.index(n) if n in self.classes else -1
                for n in names])
            keep = (labels >= 0) & valid
            b = boxes[keep]
            # nuScenes pkl boxes are bottom-center z; convert to gravity ctr
            if b.shape[1] >= 7:
                b = b.copy()
                b[:, 2] += b[:, 5] / 2
            rec['gt_boxes_3d'] = b[:, :7]
            rec['gt_labels_3d'] = labels[keep]
            # velocity (vx, vy) when the infos carry 9-dim boxes — needed by
            # the nuScenes AVE metric (eval/nuscenes_metrics.py)
            rec['gt_velocity'] = (b[:, 7:9] if b.shape[1] >= 9 else
                                  np.zeros((len(b), 2), np.float32))
            # annotation attributes (AAE): attribute-name strings -> indices
            if 'gt_attrs' in info:
                from ..eval.nuscenes_metrics import NUSC_ATTRIBUTES
                rec['gt_attrs'] = np.asarray([
                    NUSC_ATTRIBUTES.index(a) if a in NUSC_ATTRIBUTES else 0
                    for a in np.asarray(info['gt_attrs'])[keep]], np.int64)
            # 2D GT (when present in 2d-temporal infos)
            if 'bboxes2d' in info.get('annos', {}):
                an = info['annos']
                rec['gt_bboxes_2d'] = [np.asarray(x, np.float32).reshape(-1, 4)
                                       for x in an['bboxes2d']]
                rec['gt_labels_2d'] = [np.asarray(x, np.int64).reshape(-1)
                                       for x in an['labels2d']]
                rec['gt_centers_2d'] = [np.asarray(x, np.float32).reshape(-1, 2)
                                        for x in an['centers2d']]
                rec['gt_depths_2d'] = [np.asarray(x, np.float32).reshape(-1)
                                       for x in an['depths']]
            else:
                n_cams = len(paths)
                rec['gt_bboxes_2d'] = [np.zeros((0, 4), np.float32)] * n_cams
                rec['gt_labels_2d'] = [np.zeros((0,), np.int64)] * n_cams
                rec['gt_centers_2d'] = [np.zeros((0, 2), np.float32)] * n_cams
                rec['gt_depths_2d'] = [np.zeros((0,), np.float32)] * n_cams
        return rec
