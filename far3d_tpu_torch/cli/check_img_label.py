"""Data-pipeline label check of the port (the twin of
``tools/check_img_label.py``; reference tools/visual/check_img_label.py):
de-normalize the pipeline's images and overlay every label it emits, to
catch transform or intrinsics misalignment by eye.

Per camera it draws the 2D GT boxes and centres (green), the projected 3D GT
wireframes through the ida-adjusted lidar2img (yellow) and the painted
foreground depth-bin map as a translucent overlay.

    python -m far3d_tpu_torch.cli.check_img_label --data-root data/av2 \\
        [--train-aug] [--seed 0] [--out-dir vis] [--num-frames 10] [--tiny]

Writes {out-dir}/check_f{k:04d}_cam{c}.jpg. Needs no model and no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def run(argv=None):
    """Parse the command line and draw -> [(2D GTs, 3D GTs, painted depth
    pixels)] a frame."""
    from ._common import add_common_args
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    p.add_argument('--train-aug', action='store_true',
                   help='run the training pipeline (random resize) instead '
                        'of the deterministic eval transform')
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)

    from ..data.image_io import resize_nearest, write_jpeg
    from ..data.pipeline import process_frame
    from ..utils.vis import (GT_COLOR, denormalize_image, depth_color,
                             draw_boxes_2d, draw_boxes_camera, draw_points)
    from ._common import build_dataset, tool_config

    cfg = tool_config(args)
    dataset = build_dataset(cfg, args, split='train')
    rng = np.random.default_rng(args.seed)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = []
    h8 = cfg.data.input_hw[0] // cfg.depthnet.stride
    w8 = cfg.data.input_hw[1] // cfg.depthnet.stride
    for k in range(min(args.num_frames, len(dataset))):
        rec = dataset.get_frame(k)
        frame = process_frame(rec, cfg, rng, train=args.train_aug)
        gt3d = rec.get('gt_boxes_3d', np.zeros((0, 7)))
        for ci in range(frame['images'].shape[0]):
            img = np.ascontiguousarray(denormalize_image(
                frame['images'][ci], cfg.data.img_mean, cfg.data.img_std))
            fg = frame['gt_depth_fg'][ci].reshape(h8, w8)
            if fg.any():
                bins = frame['gt_depth_bins'][ci].reshape(h8, w8)
                heat = np.zeros((h8, w8, 3), np.uint8)
                heat[fg] = depth_color(
                    bins[fg].astype(np.float32), cfg.depthnet.num_depth_bins)
                heat = resize_nearest(heat, (img.shape[1], img.shape[0]))
                m = heat.any(-1, keepdims=True)
                img = np.where(m, (0.5 * img + 0.5 * heat).astype(np.uint8),
                               img)
            sel = frame['gt_mask2d'][ci]
            draw_boxes_2d(img, frame['gt_boxes2d'][ci][sel], GT_COLOR)
            draw_points(img, frame['gt_centers2d'][ci][sel], color=GT_COLOR,
                        radius=3)
            draw_boxes_camera(img, gt3d, frame['lidar2img'][ci],
                              color=(60, 220, 220))
            write_jpeg(str(out_dir / f'check_f{k:04d}_cam{ci}.jpg'), img)
        counts.append((int(frame['gt_mask2d'].sum()), len(gt3d),
                       int(frame['gt_depth_fg'].sum())))
        print(f'frame {k}: {counts[-1][0]} 2D GTs across cams, '
              f'{counts[-1][1]} 3D GTs, {counts[-1][2]} painted depth px')
    return counts


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
