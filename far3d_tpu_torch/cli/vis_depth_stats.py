"""Depth statistics of the port (the twin of ``tools/vis_depth_stats.py``;
reference tools/visual/vis_3dpred_depth_stat*.py): the range-binned
|range error| of matched 3D predictions (prediction against its nearest GT
in BEV) and the depth branch's expected-depth error on painted foreground
pixels, as one stats JSON and a histogram of each error.

    python -m far3d_tpu_torch.cli.vis_depth_stats --data-root data/av2 \\
        (--checkpoint work_dirs/far3d | --torch-checkpoint iter.pth) \\
        [--out-dir vis] [--num-frames 10] [--score-thr 0.2] [--tiny]

Writes {out-dir}/depth_stats.json and depth_stat_{pred_range,
depth_branch}.png. The JAX tool draws its histograms with matplotlib; the
card's machine has none, so these are bar charts drawn with the port's own
rasterizers (50 bins, the error in metres along x), written as PNG.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

EDGES = np.array([0, 20, 40, 60, 80, 100, 120, 150])


def histogram_png(path: str, err: np.ndarray, bins: int = 50,
                  size=(480, 720)) -> None:
    """A bar chart of `err` (50 bins over its range) with its axes."""
    from ..data.image_io import draw_rectangle, write_png
    h, w = size
    img = np.full((h, w, 3), 255, np.uint8)
    counts, _ = np.histogram(err, bins=bins)
    x0, y0, x1, y1 = 60, 40, w - 30, h - 50       # plot area
    bar_w = (x1 - x0) / bins
    top = max(int(counts.max()), 1)
    for i, c in enumerate(counts):
        if c:
            bh = int(round((y1 - y0) * c / top))
            img[y1 - bh:y1, int(x0 + i * bar_w):int(x0 + (i + 1) * bar_w)] = \
                (180, 119, 31)                     # matplotlib's C0, BGR
    draw_rectangle(img, (x0, y0), (x1, y1), (0, 0, 0))
    write_png(path, img)


def depth_stats(args):
    """Run the frames and return the stats dict the tool writes."""
    import torch

    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..geometry import lid_bin_to_depth
    from ..models.detector import decode_detections
    from ..models.farhead import init_state
    from ._common import (build_dataset, load_model, model_inputs,
                          to_numpy, tool_config)

    device = resolve_device(args.device)
    cfg = tool_config(args)
    model = load_model(cfg, args, device)
    dataset = build_dataset(cfg, args)
    dn = cfg.depthnet
    centers = lid_bin_to_depth(torch.arange(dn.num_depth_bins) + 0.5,
                               dn.depth_min, dn.depth_max, dn.num_depth_bins)
    centers_np = centers.numpy().astype(np.float64)

    tstate = init_state(1, cfg.head, device)
    range_err, range_gt, px_err, px_gt = [], [], [], []
    loader = EvalLoader(dataset, cfg, max_frames=args.num_frames,
                        device=device)
    for frame in loader:
        with torch.inference_mode():
            out = model(state=tstate, **model_inputs(frame, device))
            dets = decode_detections(out['all_cls_scores'][-1],
                                     out['all_bbox_preds'][-1],
                                     out['query_valid'], cfg)
            dl = out['outs2d']['depth_logit'].float()
            probs = torch.softmax(dl[..., :dn.num_depth_bins], -1)
            exp_depth = probs @ centers.to(probs)
        tstate = out['state']
        rec = dataset.get_frame(frame['index'])
        gt = rec.get('gt_boxes_3d', np.zeros((0, 7)))
        keep = to_numpy(dets['valid'][0]) & (
            to_numpy(dets['scores'][0]) > args.score_thr)
        pred = to_numpy(dets['boxes'][0])[keep]
        if len(gt) and len(pred):
            d = np.linalg.norm(pred[:, None, :2] - gt[None, :, :2], axis=-1)
            j = d.argmin(1)
            ok = d[np.arange(len(pred)), j] < 4.0
            pr = np.linalg.norm(pred[ok, :2], axis=-1)
            gr = np.linalg.norm(gt[j[ok], :2], axis=-1)
            range_err.extend(np.abs(pr - gr))
            range_gt.extend(gr)
        if 'gt_depth_bins' in frame:
            fg = to_numpy(frame['gt_depth_fg']).reshape(-1)
            if fg.any():
                bins = to_numpy(frame['gt_depth_bins']).reshape(-1)[fg]
                bins = np.clip(bins, 0, len(centers_np) - 1)
                gd = centers_np[bins]
                pd_ = to_numpy(exp_depth).reshape(-1)[fg]
                px_err.extend(np.abs(pd_ - gd))
                px_gt.extend(gd)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stats = {}
    for name, err, ref in (('pred_range', range_err, range_gt),
                           ('depth_branch', px_err, px_gt)):
        err, ref = np.asarray(err), np.asarray(ref)
        rows = []
        for lo, hi in zip(EDGES[:-1], EDGES[1:]):
            m = (ref >= lo) & (ref < hi)
            rows.append(dict(range=[int(lo), int(hi)], n=int(m.sum()),
                             mae=float(err[m].mean()) if m.any() else None))
        stats[name] = rows
        if len(err):
            histogram_png(str(out_dir / f'depth_stat_{name}.png'), err)
    with open(out_dir / 'depth_stats.json', 'w') as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))
    return stats


def run(argv=None):
    """Parse the command line and write the stats -> the stats dict."""
    from ._common import add_common_args
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    p.add_argument('--score-thr', type=float, default=0.2)
    return depth_stats(p.parse_args(argv))


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
