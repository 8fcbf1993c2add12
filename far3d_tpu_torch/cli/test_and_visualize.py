"""Evaluate and dump visualizations in one pass (the twin of
``tools/test_and_visualize.py``; reference tools/test_and_visualize.py:
1-283): run the test loop, draw the first --num-frames frames as
``cli.visualize`` does, and print the AV2 metrics.

    python -m far3d_tpu_torch.cli.test_and_visualize --data-root data/av2 \\
        (--checkpoint work_dirs/far3d | --torch-checkpoint iter.pth) \\
        [--out-dir vis] [--num-frames 40] [--score-thr 0.3] \\
        [--eval-range 150] [--max-eval-frames N] [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def run(argv=None):
    """-> the AV2 means (the printed dict, unrounded)."""
    from ._common import add_common_args
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--eval-range', type=float, default=None)
    p.add_argument('--max-eval-frames', type=int, default=None,
                   help='cap the evaluated shard (visualized frames always '
                        'come from its head)')
    args = p.parse_args(argv)

    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..eval.runner import collect_and_evaluate, run_inference
    from ._common import build_dataset, load_model, tool_config
    from .visualize import draw_frame

    device = resolve_device(args.device)
    cfg = tool_config(args)
    model = load_model(cfg, args, device)
    dataset = build_dataset(cfg, args)
    loader = EvalLoader(dataset, cfg, max_frames=args.max_eval_frames,
                        device=device)
    results = run_inference(cfg, model, loader, device=device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for k, det in enumerate(results[:args.num_frames]):
        draw_frame(dataset.get_frame(det['index']), det, args.score_thr,
                   out_dir, k)
    out = collect_and_evaluate(cfg, dataset, str(out_dir / 'results'), 0, 1,
                               results, eval_range_m=args.eval_range)
    if out is None:
        return None
    _, means = out
    print({k: round(float(v), 4) for k, v in means.items()})
    return means


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
