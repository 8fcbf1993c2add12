"""Closed-loop accuracy demonstration on the port: train -> decode -> match ->
metric (the twin of ``tools/overfit_demo.py``).

Overfits the tiny config on the learnable synthetic disk dataset (blob images
that encode the GT, ``utils/synthetic.py:make_learnable_dataset``, the JAX
demo's JPEG files) and
evaluates the AV2 metrics on the training frames every --eval-every steps. A
correct training, decoding, matching and metric stack drives mAP towards 1;
a target-assembly or decode fault caps it. The knobs are the JAX demo's
(lr 2.5e-3, GT depth until step 1000, batch 2).

    python -m far3d_tpu_torch.cli.overfit_demo --work /tmp/overfit \\
        --iters 2000 --eval-every 1000 [--device cpu]

Writes {work}/curve.jsonl with one {"iter", "mAP", "CDS"} line per eval. The
exit code holds the curve to the JAX package's closed-loop gate
(tests/test_closed_loop.py:25-36): mAP > 0.2 at the first evaluation, final
mAP >= 0.85 and final CDS >= 0.7.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

GATE = dict(first_map=0.2, final_map=0.85, final_cds=0.7)


def build_config(iters, eval_every=500, lr=2.5e-3, gt_depth_until=1000):
    """Tiny config plus the demo's knobs (``tools/overfit_demo.py:28-48``):
    the predicted-depth switch partway, a stronger localization term, a
    proposal budget above the blob count and finer LID bins."""
    from ..config import tiny_test_config
    cfg = tiny_test_config()
    return cfg.replace(
        train=dataclasses.replace(
            cfg.train, lr=lr, warmup_iters=50, use_grid_mask=False,
            total_iters=iters, use_gt_depth_until_iter=gt_depth_until,
            checkpoint_every=eval_every, log_every=25),
        head=dataclasses.replace(cfg.head, loss_bbox_weight=1.0),
        roi2d=dataclasses.replace(cfg.roi2d, num_proposals_2d=32),
        depthnet=dataclasses.replace(cfg.depthnet, num_depth_bins=30))


def run_closed_loop(work, iters, eval_every=500, lr=2.5e-3,
                    gt_depth_until=1000, batch=2, seed=0, device=None):
    """Build the dataset, train, evaluate every checkpoint; returns the curve
    [{'iter', 'mAP', 'CDS'}] (also appended to {work}/curve.jsonl)."""
    from ..data.av2_dataset import AV2SequenceDataset
    from ..data.loader import EvalLoader, TrainLoader
    from ..entry import resolve_device
    from ..eval.runner import collect_and_evaluate, run_inference
    from ..train.runner import run_training
    from ..utils.synthetic import make_learnable_dataset

    device = resolve_device(device)
    os.makedirs(work, exist_ok=True)
    ann = os.path.join(work, 'infos.pkl')
    make_learnable_dataset(ann, work, seed=seed)
    cfg = build_config(iters, eval_every, lr, gt_depth_until)

    eval_ds = AV2SequenceDataset(ann, work, split='val', seq_split_num=1,
                                 test_mode=False)
    curve = []
    curve_path = os.path.join(work, 'curve.jsonl')

    def eval_fn(state):
        loader = EvalLoader(eval_ds, cfg, device=device)
        results = run_inference(cfg, state.model, loader, device=device)
        _, means = collect_and_evaluate(cfg, eval_ds,
                                        os.path.join(work, 'results'),
                                        0, 1, results)
        rec = {'iter': state.step, 'mAP': float(means['mAP']),
               'CDS': float(means.get('CDS', 0.0))}
        print('EVAL', json.dumps(rec), flush=True)
        curve.append(rec)
        with open(curve_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    train_ds = AV2SequenceDataset(ann, work, split='train', seq_split_num=2)
    loader = TrainLoader(train_ds, cfg, batch_size=batch, seed=seed,
                         num_threads=2, device=device)
    try:
        state = run_training(cfg, loader, work, batch_size=batch,
                             resume=False, max_iters=iters, eval_fn=eval_fn,
                             device=device)
    finally:
        loader.stop()
    if not curve or curve[-1]['iter'] != state.step:
        eval_fn(state)
    return curve


def gate_failures(curve):
    """What the curve misses of GATE (empty when it passes)."""
    if not curve:
        return ['no evaluation ran']
    out = []
    if not curve[0]['mAP'] > GATE['first_map']:
        out.append(f"first mAP {curve[0]['mAP']:.4f} <= {GATE['first_map']}")
    if not curve[-1]['mAP'] >= GATE['final_map']:
        out.append(f"final mAP {curve[-1]['mAP']:.4f} < {GATE['final_map']}")
    if not curve[-1]['CDS'] >= GATE['final_cds']:
        out.append(f"final CDS {curve[-1]['CDS']:.4f} < {GATE['final_cds']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--work', required=True)
    ap.add_argument('--iters', type=int, default=2000)
    ap.add_argument('--eval-every', type=int, default=500)
    ap.add_argument('--lr', type=float, default=2.5e-3)
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--gt-depth-until', type=int, default=1000)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         'on the CPU)')
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    curve = run_closed_loop(args.work, args.iters, args.eval_every, args.lr,
                            args.gt_depth_until, args.batch, args.seed,
                            args.device)
    wall = time.perf_counter() - t0
    failures = gate_failures(curve)
    print(json.dumps({'curve': curve, 'wall_s': wall,
                      'gate': GATE, 'gate_failures': failures}), flush=True)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
