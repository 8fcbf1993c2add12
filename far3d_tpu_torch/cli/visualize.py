"""Visualization tool of the port (the twin of ``tools/visualize.py``;
reference tools/visualize.py / tools/visual/vis_av2.py): predicted and GT
3D boxes drawn onto each camera image and a BEV canvas, per frame.

    python -m far3d_tpu_torch.cli.visualize --data-root data/av2 \\
        (--checkpoint work_dirs/far3d | --torch-checkpoint iter.pth) \\
        [--out-dir vis] [--num-frames 20] [--score-thr 0.3] [--tiny]

Writes {out-dir}/frame{k:04d}_cam{c}.jpg and frame{k:04d}_bev.jpg (JPEG at
quality 95, as ``cv2.imwrite`` writes them, through the port's codec).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np


def draw_frame(rec, det, score_thr, out_dir: Path, k: int):
    """Draw one frame's cameras and BEV, write them; -> (preds, gts)."""
    from ..data.image_io import read_image, write_jpeg
    from ..utils.vis import GT_COLOR, PRED_COLOR, draw_bev, draw_boxes_camera
    keep = det['scores'] > score_thr
    pred = det['boxes'][keep]
    gt = rec.get('gt_boxes_3d', np.zeros((0, 7)))
    for ci, path in enumerate(rec['img_paths']):
        if not os.path.exists(path):
            continue
        img = read_image(path)
        draw_boxes_camera(img, gt, rec['lidar2img'][ci], GT_COLOR)
        draw_boxes_camera(img, pred, rec['lidar2img'][ci], PRED_COLOR)
        write_jpeg(str(out_dir / f'frame{k:04d}_cam{ci}.jpg'), img)
    write_jpeg(str(out_dir / f'frame{k:04d}_bev.jpg'), draw_bev(pred, gt))
    return len(pred), len(gt)


def run(argv=None):
    """Parse the command line and draw -> [(predictions, GT boxes)] a
    drawn frame."""
    from ._common import add_common_args
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]), split_flags=False)
    p.add_argument('--score-thr', type=float, default=0.3)
    args = p.parse_args(argv)
    if not (args.checkpoint or args.torch_checkpoint):
        p.error('need --checkpoint or --torch-checkpoint')

    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..eval.runner import run_inference
    from ._common import build_dataset, load_model, tool_config

    device = resolve_device(args.device)
    cfg = tool_config(args)
    dataset = build_dataset(cfg, args)
    model = load_model(cfg, args, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = run_inference(cfg, model, EvalLoader(dataset, cfg,
                                                   device=device),
                            device=device)
    counts = []
    for k, det in enumerate(results[:args.num_frames]):
        rec = dataset.get_frame(det['index'])
        counts.append(draw_frame(rec, det, args.score_thr, out_dir, k))
        print(f'frame {k}: {counts[-1][0]} preds, {counts[-1][1]} gts')
    return counts


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
