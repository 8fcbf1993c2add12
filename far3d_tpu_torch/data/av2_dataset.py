"""Argoverse 2 info-pkl dataset (a copy of ``far3d_tpu/data/av2_dataset.py``;
reference datasets/argoverse2_dataset.py + argoverse2_dataset_t.py).

Reads `av2_{split}_infos.pkl` produced by tools/create_av2_infos.py (same
schema as the reference converter, create_av2_infos.py:38-114): per frame a
dict with scene_id, lidar_timestamp_ns, city_SE3_ego_lidar_t, cam_infos
{name -> fpath/intrinsics/ego_SE3_cam/city_SE3_ego_cam_t/cam_timestamp_ns},
gt3d_infos {gt_boxes (M,7) xyz(gravity)+lwh+yaw, gt_names, num_interior_pts}
and gt2d_infos {gt_2dbboxes, gt_2dlabels, centers2d, depths} per camera.

Geometry (argoverse2_dataset_t.py:190-213): per camera
  extrinsic (ego->cam) = ego_SE3_cam^-1 ∘ city_SE3_ego_cam_t^-1 ∘ city_SE3_ego_lidar_t
  lidar2img = 4x4-padded intrinsics @ extrinsic
and ego_pose = city_SE3_ego_lidar_t as a 4x4 matrix; timestamp = frame index
(argoverse2_dataset_t.py:179 — the reference uses the dataset index, not
nanoseconds).

SE3 values may be av2-devkit SE3 objects, (4,4) arrays, or
{'rotation','translation'} dicts — all are normalized to 4x4 numpy.
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import AV2_CLASS_NAMES


def se3_to_matrix(se3) -> np.ndarray:
    if isinstance(se3, np.ndarray) and se3.shape == (4, 4):
        return se3.astype(np.float64)
    if isinstance(se3, dict):
        m = np.eye(4)
        m[:3, :3] = np.asarray(se3['rotation'])
        m[:3, 3] = np.asarray(se3['translation'])
        return m
    # av2 devkit SE3 object
    m = np.eye(4)
    m[:3, :3] = np.asarray(se3.rotation)
    m[:3, 3] = np.asarray(se3.translation)
    return m


def invert_se3(m: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=m.dtype)
    r = m[:3, :3]
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ m[:3, 3]
    return out


def quat_wxyz_to_yaw(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz -> yaw about +z (av2 cuboids are axis-aligned in pitch/
    roll for the competition taxonomy)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


class AV2SequenceDataset:
    """Temporal AV2 dataset with per-scene stream groups.

    Mirrors Argoverse2DatasetT semantics: frames sorted per scene, scene
    groups optionally sub-split (`seq_split_num`, :57-79), `prev_exists` from
    the group flag (:215-218), interval_test reordering for eval streams
    (:27-31)."""

    def __init__(self,
                 ann_file: str,
                 data_root: str,
                 split: str = 'train',
                 classes: Sequence[str] = AV2_CLASS_NAMES,
                 load_interval: int = 1,
                 seq_split_num: int = 2,
                 interval_test: bool = False,
                 test_mode: bool = False,
                 filter_empty_gt: bool = True):
        self.data_root = Path(data_root)
        self.split = split
        self.classes = list(classes)
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        with open(ann_file, 'rb') as f:
            data = pickle.load(f)
        infos = data['infos'][::load_interval]
        if interval_test:
            s = [infos[i::5] for i in range(5)]
            infos = sum(s, [])
        self.infos = infos
        self.seq_split_num = seq_split_num
        self._set_group_flags()

    # ------------------------------------------------------------------
    def _set_group_flags(self):
        flags = []
        scene, cur = None, -1
        for info in self.infos:
            if info['scene_id'] != scene:
                scene = info['scene_id']
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

    def __len__(self) -> int:
        return len(self.infos)

    # ------------------------------------------------------------------
    def get_frame(self, index: int) -> Optional[Dict]:
        """Raw (pre-pipeline) record for one frame."""
        info = self.infos[index]
        ego_pose = se3_to_matrix(info['city_SE3_ego_lidar_t'])
        rec = dict(
            index=index,
            scene_token=info['scene_id'],
            lidar_timestamp=info.get('lidar_timestamp_ns', 0),
            timestamp=float(index),      # reference uses index as timestamp
            ego_pose=ego_pose.astype(np.float32),
            ego_pose_inv=invert_se3(ego_pose).astype(np.float32),
            prev_exists=float(not (index == 0 or
                                   self.flag[index - 1] != self.flag[index])),
        )
        paths, l2i, intr, extr, cam_ts = [], [], [], [], []
        for cam_name, cam in info['cam_infos'].items():
            if cam is None:
                return None
            city_from_egocam = se3_to_matrix(cam['city_SE3_ego_cam_t'])
            ego_from_cam = se3_to_matrix(cam['ego_SE3_cam'])
            ego2cam = invert_se3(ego_from_cam) @ invert_se3(city_from_egocam) \
                @ ego_pose
            viewpad = np.eye(4)
            k = np.asarray(cam['intrinsics'])
            viewpad[:k.shape[0], :k.shape[1]] = k
            paths.append(str(self.data_root / cam['fpath']))
            intr.append(viewpad)
            extr.append(ego2cam)
            l2i.append(viewpad @ ego2cam)
            cam_ts.append(cam.get('cam_timestamp_ns', 0) / 1e9)
        rec.update(img_paths=paths,
                   lidar2img=np.asarray(l2i, np.float32),
                   intrinsics=np.asarray(intr, np.float32),
                   extrinsics=np.asarray(extr, np.float32),
                   img_timestamp=np.asarray(cam_ts, np.float64))

        if not self.test_mode:
            gt3d = info['gt3d_infos']
            mask = np.asarray(gt3d['num_interior_pts']) > 0
            boxes = np.asarray(gt3d['gt_boxes'], np.float32)[mask]
            names = np.asarray(gt3d['gt_names'])[mask]
            labels = np.asarray([
                self.classes.index(n) if n in self.classes else -1
                for n in names], np.int64)
            keep = labels >= 0
            rec['gt_boxes_3d'] = boxes[keep]      # (M, 7) gravity-center
            rec['gt_labels_3d'] = labels[keep]
            gt2d = info['gt2d_infos']
            rec['gt_bboxes_2d'] = [np.asarray(b, np.float32).reshape(-1, 4)
                                   for b in gt2d['gt_2dbboxes']]
            rec['gt_labels_2d'] = [np.asarray(l, np.int64).reshape(-1)
                                   for l in gt2d['gt_2dlabels']]
            rec['gt_centers_2d'] = [np.asarray(c, np.float32).reshape(-1, 2)
                                    for c in gt2d['centers2d']]
            rec['gt_depths_2d'] = [np.asarray(d, np.float32).reshape(-1)
                                   for d in gt2d['depths']]
        return rec
