"""nuScenes visualization for the StreamPETR family, by the port (the twin of
``tools/visualize_nusc.py``; reference tools/visual_nuscenes.py, its 6-camera
+ BEV composite): per frame, predicted (red) and GT (green) 3D wireframes on
every raw camera image, composed into a surround grid of 3 columns with a
BEV panel on the right, one composite JPEG a frame.

    python -m far3d_tpu_torch.cli.visualize_nusc --data-root data/nuscenes \\
        (--checkpoint work_dirs/streampetr | --random-init) \\
        [--out-dir vis_nusc] [--num-frames 20] [--score-thr 0.3] \\
        [--src-wh 1600 900] [--set KEY=VAL] [--tiny] [--device cpu]

Writes {out-dir}/frame{k:04d}.jpg.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np


def _to_draw_boxes(boxes9: np.ndarray, bottom_z: bool) -> np.ndarray:
    """decode_boxes rows (x, y, z, w, l, h, yaw[, vx, vy]) -> the drawing
    layout box_corners expects ([x, y, z_gravity, l, w, h, yaw])."""
    if len(boxes9) == 0:
        return np.zeros((0, 7))
    b = np.asarray(boxes9, np.float64)[:, :7].copy()
    if bottom_z:
        b[:, 2] += b[:, 5] / 2
    b[:, [3, 4]] = b[:, [4, 3]]
    return b


def render_nusc_frame(rec, det, score_thr: float = 0.3,
                      bev_extent: float = 65.0) -> np.ndarray:
    """One frame's composite: raw camera images with GT / predicted
    wireframes and the BEV. `rec` is a ``NuScenesSequenceDataset`` frame
    record; `det` a ``run_inference_petr`` result (boxes, scores, labels in
    decode order). A camera file that is missing is drawn on a dark canvas,
    as the JAX tool does."""
    from ..data.image_io import read_image
    from ..utils.vis import (GT_COLOR, PRED_COLOR, compose_camera_grid,
                             draw_bev, draw_boxes_camera)
    keep = np.asarray(det['scores']) > score_thr
    pred = _to_draw_boxes(np.asarray(det['boxes'])[keep], bottom_z=True)
    gt = _to_draw_boxes(rec.get('gt_boxes_3d', np.zeros((0, 7))),
                        bottom_z=False)
    cams = []
    for ci, path in enumerate(rec['img_paths']):
        img = read_image(path) if os.path.exists(path) else \
            np.full((450, 800, 3), 20, np.uint8)
        draw_boxes_camera(img, gt, rec['lidar2img'][ci], GT_COLOR)
        draw_boxes_camera(img, pred, rec['lidar2img'][ci], PRED_COLOR)
        cams.append(img)
    bev = draw_bev(pred, gt, extent=bev_extent, size=800)
    return compose_camera_grid(cams, cols=3, bev=bev)


def run(argv=None):
    """Parse the command line and draw -> [(predictions, GT boxes)] a
    frame."""
    from ._common import add_device_args
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--ann-file', default=None)
    p.add_argument('--checkpoint', default=None,
                   help='work dir of cli.train_nusc (its latest checkpoint)')
    p.add_argument('--random-init', action='store_true')
    p.add_argument('--src-wh', type=int, nargs=2, default=(1600, 900))
    p.add_argument('--out-dir', default='vis_nusc')
    p.add_argument('--num-frames', type=int, default=10)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--set', dest='overrides', action='append', default=[],
                   metavar='KEY=VAL', help='dotted StreamPETRConfig overrides')
    add_device_args(p)
    args = p.parse_args(argv)
    if not (args.checkpoint or args.random_init):
        raise SystemExit('need --checkpoint or --random-init')

    from ..config import TrainConfig, apply_overrides
    from ..data.image_io import write_jpeg
    from ..data.loader import EvalLoader
    from ..data.nuscenes_dataset import NuScenesSequenceDataset
    from ..entry import build_petr_model, resolve_device
    from ..eval.petr_runner import petr_host_config, run_inference_petr
    from ..models.streampetr import StreamPETRConfig, tiny_petr_config
    from ..train.petr_step import create_petr_train_state
    from ..utils.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    cfg = apply_overrides(tiny_petr_config() if args.tiny
                          else StreamPETRConfig(), args.overrides)
    ann = args.ann_file or \
        f'{args.data_root}/nuscenes2d_temporal_infos_val.pkl'
    dataset = NuScenesSequenceDataset(ann, args.data_root, seq_split_num=1)
    host_cfg = petr_host_config(cfg, tuple(args.src_wh))
    model = build_petr_model(cfg, device)
    if args.checkpoint:
        state, _ = create_petr_train_state(model, TrainConfig())
        if CheckpointManager(args.checkpoint).restore(state) is None:
            raise SystemExit(f'no checkpoint found in {args.checkpoint}')
    loader = EvalLoader(dataset, host_cfg, max_frames=args.num_frames,
                        device=device)
    results = run_inference_petr(cfg, model, loader, device=device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = []
    for k, det in enumerate(results):
        rec = dataset.get_frame(det['index'])
        write_jpeg(str(out_dir / f'frame{k:04d}.jpg'),
                   render_nusc_frame(rec, det, args.score_thr))
        counts.append((int((np.asarray(det['scores']) > args.score_thr).sum()),
                       len(rec.get('gt_boxes_3d', []))))
        print(f'frame {k}: {counts[-1][0]} preds, {counts[-1][1]} gts')
    return counts


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
