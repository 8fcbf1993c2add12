"""Deformable-attention visualization of the port (the twin of
``tools/vis_attention.py``; reference tools/visual/vis_attention.py): each
top-scoring decoded query's sampling points on the camera images, coloured
by their camera-softmax weight (summed over groups and levels).

    python -m far3d_tpu_torch.cli.vis_attention --data-root data/av2 \\
        (--checkpoint work_dirs/far3d | --torch-checkpoint iter.pth) \\
        [--num-queries 8] [--layer -1] [--score-thr 0.2] [--tiny]

The decoder's ``DeformableAggregation`` modules hand out their sampling
locations and weights within ``models/decoder.py:capture_sampling`` (the JAX
module sows them). Writes {out-dir}/attn_f{k:04d}_l{layer}_cam{c}.jpg.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def run(argv=None):
    """Parse the command line and draw -> [(queries, points, cameras)] a
    frame."""
    from ._common import add_common_args
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    p.add_argument('--num-queries', type=int, default=8)
    p.add_argument('--layer', type=int, default=-1,
                   help='decoder layer to visualize (default: last)')
    p.add_argument('--score-thr', type=float, default=0.2)
    args = p.parse_args(argv)

    import torch

    from ..data.image_io import write_jpeg
    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..models.decoder import capture_sampling
    from ..models.detector import decode_detections
    from ..models.farhead import init_state
    from ..utils.vis import denormalize_image, draw_points
    from ._common import (build_dataset, load_model, model_inputs, to_numpy,
                          tool_config)

    device = resolve_device(args.device)
    cfg = tool_config(args)
    model = load_model(cfg, args, device)
    dataset = build_dataset(cfg, args)
    tstate = init_state(1, cfg.head, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pad_h, pad_w = cfg.data.input_hw
    layer = args.layer % cfg.decoder.num_layers
    loader = EvalLoader(dataset, cfg, max_frames=args.num_frames,
                        device=device)
    counts = []
    for k, frame in enumerate(loader):
        with torch.inference_mode(), capture_sampling(model) as layers:
            out = model(state=tstate, **model_inputs(frame, device))
            dets = decode_detections(out['all_cls_scores'][-1],
                                     out['all_bbox_preds'][-1],
                                     out['query_valid'], cfg)
        tstate = out['state']
        agg = layers[layer][-1]
        loc = to_numpy(agg['sampling_loc'])            # (N, Q, P, 2) in [0,1]
        w = to_numpy(agg['attn_weights'])              # (N, Q, G, L, P)
        n_cams = loc.shape[0]
        wp = w.sum(axis=(2, 3))                        # (N, Q, P)
        scores = to_numpy(dets['scores'][0])
        keep = (scores > args.score_thr) & to_numpy(dets['valid'][0])
        order = np.argsort(-scores)[:args.num_queries]
        order = order[keep[order]]
        qidx = to_numpy(dets['query_idx'][0])
        images = to_numpy(frame['images'])
        for ci in range(n_cams):
            img = np.ascontiguousarray(denormalize_image(
                images[ci], cfg.data.img_mean, cfg.data.img_std))
            for di in order:
                qi = int(qidx[di])
                uv = loc[ci, qi] * np.asarray([pad_w, pad_h])
                wq = wp[ci, qi]
                wq = wq / max(float(wq.max()), 1e-6)
                colors = (np.stack([np.full_like(wq, 60), 255 * (1 - wq),
                                    255 * wq], axis=-1)).astype(np.uint8)
                draw_points(img, uv, colors=colors, radius=3)
            write_jpeg(str(out_dir / f'attn_f{k:04d}_l{layer}_cam{ci}.jpg'),
                       img)
        counts.append((len(order), loc.shape[2], n_cams))
        print(f'frame {k}: drew {len(order)} queries x {loc.shape[2]} points '
              f'x {n_cams} cams (layer {layer})')
    return counts


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
