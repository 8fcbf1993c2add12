"""The full-size closed loop on the card (the twin of
``tools/overfit_full.py``): overfit the production ``Far3DConfig`` (960x640,
7 cameras, 644 queries + 256 proposals, DN on, 6 decoder layers, the MSDA
kernels forward and backward, the auction matching) on the learnable
synthetic dataset at native AV2 sizes (``utils/synthetic.py:
make_learnable_dataset_fullsize``, 2 scenes x 8 frames, PNG) and evaluate
through the production eval path (``EvalLoader`` -> ``run_inference`` ->
AV2 metrics) every --eval-every steps.

    python -m far3d_tpu_torch.cli.overfit_full --work /tmp/overfit_full \\
        --iters 2500 --eval-every 500 --assert-map 0.8 [--device cpu]

Every frame goes through ``process_frame`` once, with the eval
augmentation, and the cached frames stream through the scene-group sampler
that training uses (``CachedStreamLoader``), so the host pipeline is off
the step. Writes {work}/curve.jsonl with one {"iter", "mAP", "CDS"} line per
eval. --assert-map makes the final mAP an exit-code gate. --resume goes on
from the latest checkpoint in --work; the data stream and the temporal
memory restart there, so a resumed curve is a valid learning trajectory but
not bit-identical to an uninterrupted one. --tiny runs the tiny test config
on the tiny learnable dataset (``make_learnable_dataset``), a CPU smoke of
this tool.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def build_config(iters, eval_every, lr=1e-3, gt_depth_until=None,
                 tiny=False):
    """``Far3DConfig()`` (or the tiny test config) with only the schedule
    and learning-rate knobs of a short overfit (overfit_full.py:40-48): lr,
    warmup 100, no grid mask, GT depth until `gt_depth_until` (default
    iters // 2), a checkpoint and an eval every `eval_every`."""
    from ..config import Far3DConfig, tiny_test_config
    cfg = tiny_test_config() if tiny else Far3DConfig()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, lr=lr, warmup_iters=100, use_grid_mask=False,
        total_iters=iters, checkpoint_every=eval_every, log_every=50,
        use_gt_depth_until_iter=(iters // 2 if gt_depth_until is None
                                 else gt_depth_until)))


class CachedStreamLoader:
    """overfit_full.py:51-78: the scene-group stream of ``TrainLoader``
    (lanes never change scene mid-stream) over frames processed once with
    the deterministic eval augmentation."""

    def __init__(self, dataset, cfg, batch_size, seed=0, device=None):
        import numpy as np

        from ..data.loader import _stack_batch
        from ..data.pipeline import process_frame
        from ..data.sampler import InfiniteGroupStreamSampler
        from ..entry import resolve_device
        self._pin = resolve_device(device).type == 'cuda'
        self._stack = _stack_batch
        self.frames = [process_frame(dataset.get_frame(i), cfg,
                                     np.random.default_rng(0), train=False)
                       for i in range(len(dataset))]
        self.sampler = InfiniteGroupStreamSampler(dataset.flag, batch_size,
                                                  0, 1, seed)

    def __iter__(self):
        for indices in self.sampler:
            yield self._stack([self.frames[i] for i in indices], self._pin)


def run_closed_loop_full(work, iters, eval_every=500, lr=1e-3,
                         gt_depth_until=None, batch=1, seed=0, resume=False,
                         tiny=False, device=None):
    """Write the dataset (once per --work), train, evaluate every
    `eval_every` steps and at the end; returns the curve
    [{'iter', 'mAP', 'CDS'}] (also appended to {work}/curve.jsonl)."""
    from ..data.av2_dataset import AV2SequenceDataset
    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..eval.runner import collect_and_evaluate, run_inference
    from ..train.runner import run_training
    from ..utils.synthetic import (make_learnable_dataset,
                                   make_learnable_dataset_fullsize)

    device = resolve_device(device)
    os.makedirs(work, exist_ok=True)
    ann = os.path.join(work, 'infos.pkl')
    if not os.path.exists(ann):
        print('# writing the learnable dataset', flush=True)
        (make_learnable_dataset if tiny else make_learnable_dataset_fullsize)(
            ann, work, seed=seed)
    cfg = build_config(iters, eval_every, lr, gt_depth_until, tiny)

    eval_ds = AV2SequenceDataset(ann, work, split='val', seq_split_num=1,
                                 test_mode=False)
    curve = []
    curve_path = os.path.join(work, 'curve.jsonl')

    def eval_fn(state):
        t0 = time.perf_counter()
        results = run_inference(cfg, state.model,
                                EvalLoader(eval_ds, cfg, device=device),
                                device=device)
        _, means = collect_and_evaluate(cfg, eval_ds,
                                        os.path.join(work, 'results'), 0, 1,
                                        results)
        rec = {'iter': state.step, 'mAP': float(means['mAP']),
               'CDS': float(means.get('CDS', 0.0)),
               'eval_s': time.perf_counter() - t0}
        print('EVAL', json.dumps(rec), flush=True)
        curve.append(rec)
        with open(curve_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    train_ds = AV2SequenceDataset(ann, work, split='train', seq_split_num=2)
    print('# caching the processed frames', flush=True)
    loader = CachedStreamLoader(train_ds, cfg, batch, seed, device)
    state = run_training(cfg, loader, work, batch_size=batch, resume=resume,
                         max_iters=iters, eval_fn=eval_fn, device=device)
    if not curve or curve[-1]['iter'] != state.step:
        eval_fn(state)
    return curve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--work', required=True)
    ap.add_argument('--iters', type=int, default=2500)
    ap.add_argument('--eval-every', type=int, default=500)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--gt-depth-until', type=int, default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--assert-map', type=float, default=None,
                    help='exit 1 unless the final mAP reaches this')
    ap.add_argument('--resume', action='store_true',
                    help='go on from the latest checkpoint in --work (see '
                         'the module docstring)')
    ap.add_argument('--tiny', action='store_true',
                    help='tiny test config and dataset (a CPU smoke of this '
                         'tool)')
    ap.add_argument('--device', default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         'on the CPU)')
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    curve = run_closed_loop_full(args.work, args.iters, args.eval_every,
                                 args.lr, args.gt_depth_until, args.batch,
                                 args.seed, args.resume, args.tiny,
                                 args.device)
    final = curve[-1]['mAP'] if curve else 0.0
    print(json.dumps({'curve': curve, 'wall_s': time.perf_counter() - t0,
                      'final_mAP': final}), flush=True)
    if args.assert_map is not None:
        if final < args.assert_map:
            print(f'FAIL: final mAP {final:.4f} < {args.assert_map}')
            return 1
        print(f'PASS: final mAP {final:.4f} >= {args.assert_map}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
