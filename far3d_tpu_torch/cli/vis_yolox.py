"""2D proposal visualization of the port (the twin of
``tools/vis_yolox.py``; reference tools/visual/vis_yolox.py:60-109): the
detector's static top-K proposals (score-annotated, red) and the pipeline's
2D GT boxes (green) on the network-input images.

    python -m far3d_tpu_torch.cli.vis_yolox --data-root data/av2 \\
        (--checkpoint work_dirs/far3d | --torch-checkpoint iter.pth) \\
        [--out-dir vis] [--num-frames 10] [--tiny] [--device cpu]

Writes {out-dir}/yolox_f{k:04d}_cam{c}.jpg. Without weights the model is
seeded random, so the pipeline can be looked at untrained.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def run(argv=None):
    """Parse the command line and draw -> [(valid proposals, max score)] a
    frame."""
    from ._common import add_common_args
    args = add_common_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0])).parse_args(argv)

    import torch

    from ..data.image_io import write_jpeg
    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..models.farhead import init_state
    from ..utils.vis import (GT_COLOR, PRED_COLOR, denormalize_image,
                             draw_boxes_2d, draw_points)
    from ._common import (build_dataset, load_model, model_inputs, to_numpy,
                          tool_config)

    device = resolve_device(args.device)
    cfg = tool_config(args)
    model = load_model(cfg, args, device)
    dataset = build_dataset(cfg, args)
    tstate = init_state(1, cfg.head, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    loader = EvalLoader(dataset, cfg, max_frames=args.num_frames,
                        device=device)
    counts = []
    for k, frame in enumerate(loader):
        with torch.inference_mode():
            out = model(state=tstate, **model_inputs(frame, device))
        tstate = out['state']
        props = out['proposals']
        boxes = to_numpy(props['boxes'][0])                 # (K, 4) cxcywh
        scores = to_numpy(props['scores'][0]).reshape(-1)
        cam_idx = to_numpy(props['cam_idx'][0])
        valid = to_numpy(props['valid'][0])
        xyxy = np.concatenate([boxes[:, :2] - boxes[:, 2:] / 2,
                               boxes[:, :2] + boxes[:, 2:] / 2], axis=1)
        images = to_numpy(frame['images'])
        for ci in range(images.shape[0]):
            img = np.ascontiguousarray(denormalize_image(
                images[ci], cfg.data.img_mean, cfg.data.img_std))
            sel = valid & (cam_idx == ci)
            draw_boxes_2d(img, xyxy[sel], PRED_COLOR, scores=scores[sel])
            if 'gt_boxes2d' in frame:
                gsel = to_numpy(frame['gt_mask2d'][ci])
                draw_boxes_2d(img, to_numpy(frame['gt_boxes2d'][ci])[gsel],
                              GT_COLOR)
                draw_points(img, to_numpy(frame['gt_centers2d'][ci])[gsel],
                            color=GT_COLOR, radius=3)
            write_jpeg(str(out_dir / f'yolox_f{k:04d}_cam{ci}.jpg'), img)
        counts.append((int(valid.sum()), float(scores.max())))
        print(f'frame {k}: {counts[-1][0]} proposals > thr '
              f'(max score {counts[-1][1]:.3f})')
    return counts


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
