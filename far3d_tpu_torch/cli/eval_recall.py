"""2D proposal recall probe of the port (the twin of ``tools/eval_recall.py``;
reference datasets/eval_recall.py:86-150): how many GT 2D boxes the YOLOX
proposal stage recovers, bucketed by GT depth range.

    python -m far3d_tpu_torch.cli.eval_recall --data-root data/av2 \\
        (--checkpoint work_dirs/far3d | --torch-checkpoint iter.pth) \\
        [--num-frames 100] [--iou-thr 0.5] [--tiny] [--device cpu]
    python -m far3d_tpu_torch.cli.eval_recall --synthetic [--device cpu]

--synthetic draws the recall-vs-K curve of the static top-K selection
(``models/heads2d.py:select_proposals``) on synthetic dense score maps at
full resolution, with no data or weights: the JAX tool's draws, from the
same numpy generator.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def iou_xyxy(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def synthetic_recall_curve(ks=(64, 128, 192, 256, 384, 512), n_frames=20,
                           gt_per_frame=280, fp_ratio=2.0, seed=0,
                           threshold=0.1, device='cpu'):
    """Recall-vs-K of the static top-K proposal selection on synthetic dense
    scenes (eval_recall.py:36-110): GT peaks (score U(0.3, 0.99)) and
    `fp_ratio` x false-positive peaks (score U(threshold + 0.01, 0.4))
    painted onto full-resolution 7-camera score maps, then routed through
    ``select_proposals``. -> {K: recall}."""
    import torch

    from ..config import Far3DConfig
    from ..models.heads2d import select_proposals

    cfg = Far3DConfig()
    h, w = cfg.data.input_hw
    level_hw = [(h // s, w // s) for s in cfg.strides]
    n_cams = cfg.data.num_cams
    rng = np.random.default_rng(seed)
    results = {k: [0, 0] for k in ks}
    for _ in range(n_frames):
        cls = [np.full((n_cams,) + hw + (1,), -20.0, np.float32)
               for hw in level_hw]
        obj = [np.full((n_cams,) + hw + (1,), 20.0, np.float32)
               for hw in level_hw]
        bbox = [np.zeros((n_cams,) + hw + (4,), np.float32)
                for hw in level_hw]
        gt_flat = []

        def paint(n, lo, hi, record):
            for _ in range(n):
                ci = int(rng.integers(n_cams))
                li = int(rng.integers(len(level_hw)))
                hh, ww = level_hw[li]
                yy = int(rng.integers(1, hh - 1))
                xx = int(rng.integers(1, ww - 1))
                s = float(rng.uniform(lo, hi))
                cls[li][ci, yy, xx, 0] = float(np.log(s / (1 - s)))
                if record:
                    gt_flat.append((ci, li, yy, xx))

        paint(gt_per_frame, 0.3, 0.99, True)
        paint(int(gt_per_frame * fp_ratio), threshold + 0.01, 0.4, False)
        outs = {name: [torch.from_numpy(a).to(device) for a in arrs]
                for name, arrs in (('cls_scores', cls),
                                   ('objectnesses', obj),
                                   ('bbox_preds', bbox))}
        offs = np.cumsum([0] + [hh * ww for hh, ww in level_hw])
        gt_idx = {ci: set() for ci in range(n_cams)}
        for ci, li, yy, xx in gt_flat:
            gt_idx[ci].add(int(offs[li] + yy * level_hw[li][1] + xx))
        for k in ks:
            sel = select_proposals(outs, 1, n_cams, cfg.strides, k, threshold)
            cam = sel['cam_idx'][0].cpu().numpy()
            flat = sel['flat_idx'][0].cpu().numpy()
            valid = sel['valid'][0].cpu().numpy()
            hit = sum(1 for c, f, v in zip(cam, flat, valid)
                      if v and int(f) in gt_idx[int(c)])
            results[k][0] += hit
            results[k][1] += len(gt_flat)
    print(f'# synthetic dense scenes: {gt_per_frame} GT peaks/frame, '
          f'{fp_ratio}x false positives, {n_frames} frames')
    for k in ks:
        hit, tot = results[k]
        print(f'K={k:>4}: GT-peak recall {hit / tot:.4f} ({hit}/{tot})')
    return {k: results[k][0] / results[k][1] for k in ks}


BUCKETS = [(0, 30), (30, 75), (75, 150)]


def recall_by_range(args):
    """The dataset mode: {(lo, hi): (hits, total)} of GT 2D boxes matched
    (IoU >= --iou-thr) by a valid proposal of their camera."""
    import torch

    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..models.farhead import init_state
    from ._common import build_dataset, load_model, model_inputs, tool_config

    device = resolve_device(args.device)
    cfg = tool_config(args)
    dataset = build_dataset(cfg, args)
    model = load_model(cfg, args, device)
    hits = {b: 0 for b in BUCKETS}
    total = {b: 0 for b in BUCKETS}
    tstate = init_state(1, cfg.head, device)
    loader = EvalLoader(dataset, cfg, max_frames=args.num_frames,
                        device=device)
    for frame in loader:
        rec = dataset.get_frame(frame['index'])
        with torch.inference_mode():
            out = model(state=tstate, **model_inputs(frame, device))
        tstate = out['state']
        props = out['proposals']
        boxes = props['boxes'][0].float().cpu().numpy()      # cxcywh
        cam = props['cam_idx'][0].cpu().numpy()
        valid = props['valid'][0].cpu().numpy()
        xyxy = np.concatenate([boxes[:, :2] - boxes[:, 2:] / 2,
                               boxes[:, :2] + boxes[:, 2:] / 2], axis=1)
        for ci in range(cfg.data.num_cams):
            gt = rec['gt_bboxes_2d'][ci]
            gd = rec['gt_depths_2d'][ci]
            pred = xyxy[(cam == ci) & valid]
            ious = iou_xyxy(gt, pred)
            matched = ious.max(axis=1) >= args.iou_thr if len(pred) else \
                np.zeros(len(gt), bool)
            for b in BUCKETS:
                sel = (gd >= b[0]) & (gd < b[1])
                total[b] += int(sel.sum())
                hits[b] += int((matched & sel).sum())
    for b in BUCKETS:
        r = hits[b] / max(total[b], 1)
        print(f'range {b[0]:>3.0f}-{b[1]:>3.0f} m: recall {r:.4f} '
              f'({hits[b]}/{total[b]})')
    return {b: (hits[b], total[b]) for b in BUCKETS}


def run(argv=None):
    """Parse the command line and probe -> {K: recall} (--synthetic) or
    {(lo, hi): (hits, total)}."""
    from ._common import add_device_args
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--synthetic', action='store_true',
                   help='recall-vs-K curve on synthetic dense scenes '
                        '(no data/checkpoint needed)')
    p.add_argument('--gt-per-frame', type=int, default=280)
    p.add_argument('--data-root', default=None)
    p.add_argument('--ann-file', default=None)
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--torch-checkpoint', default=None)
    p.add_argument('--num-frames', type=int, default=100)
    p.add_argument('--iou-thr', type=float, default=0.5)
    add_device_args(p)
    args = p.parse_args(argv)
    if args.synthetic:
        from ..entry import resolve_device
        return synthetic_recall_curve(gt_per_frame=args.gt_per_frame,
                                      device=resolve_device(args.device))
    if args.data_root is None:
        p.error('--data-root is required unless --synthetic')
    if not (args.checkpoint or args.torch_checkpoint):
        p.error('need --checkpoint or --torch-checkpoint')
    return recall_by_range(args)


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
