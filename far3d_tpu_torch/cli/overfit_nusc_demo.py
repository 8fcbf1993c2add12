"""Closed-loop accuracy demonstration of StreamPETR on the port: train ->
decode -> match -> nuScenes metric (the twin of
``tools/overfit_nusc_demo.py``).

Overfits the tiny StreamPETR config on the learnable synthetic nuScenes
dataset (``utils/synthetic.py:make_learnable_nusc_dataset``, the JAX demo's
JPEG files) and
evaluates the nuScenes protocol on the training frames every --eval-every
steps. A correct training, decoding, matching and metric stack drives mAP
towards 1; a target-assembly, codec or metric fault caps it. The knobs are
the JAX demo's (lr 2.5e-3, warm-up 50, no grid mask, no EMA, batch 2).

    python -m far3d_tpu_torch.cli.overfit_nusc_demo --work /tmp/ovn \\
        --iters 2500 [--eval-every 500] [--seed 0] [--dropout 0]
        [--image-format png] [--device cpu]

Writes {work}/curve.jsonl with one {"iter", "mAP", "NDS"} line per eval and
leaves the final train state in {work}. The exit code holds the curve to the
JAX package's gate (tests/test_closed_loop.py:39-57): final mAP >= 0.75 and
final NDS >= 0.7.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

GATE = dict(final_map=0.75, final_nds=0.7)


def build_configs(iters, lr=2.5e-3, eval_every=500):
    """Tiny StreamPETR config and the demo's training knobs
    (``tools/overfit_nusc_demo.py:34-43``)."""
    from ..config import TrainConfig
    from ..models.streampetr import tiny_petr_config
    tcfg = dataclasses.replace(
        TrainConfig(), lr=lr, warmup_iters=50, use_grid_mask=False,
        total_iters=iters, use_gt_depth_until_iter=0, ema_decay=0.0,
        checkpoint_every=eval_every, log_every=100)
    return tiny_petr_config(), tcfg


def host_config(cfg):
    """The host pipeline's config: identity resize, 8 GT slots."""
    from ..eval.petr_runner import petr_host_config
    h, w = cfg.input_hw
    host = petr_host_config(cfg, (w, h))
    return host.replace(data=dataclasses.replace(host.data, max_gt=8,
                                                 max_gt_2d=8))


def run_closed_loop_nusc(work, iters, eval_every=500, lr=2.5e-3, batch=2,
                         seed=0, device=None, dropout=None,
                         image_format='jpg'):
    """Build the dataset, train, evaluate every eval_every steps; returns the
    curve [{'iter', 'mAP', 'NDS'}] (also appended to {work}/curve.jsonl).
    `dropout` replaces the tiny config's rate (0.1, the JAX demo's);
    `image_format` 'png' writes the same images losslessly in place of the
    JAX demo's JPEG files."""
    from ..data.loader import EvalLoader, TrainLoader
    from ..data.nuscenes_dataset import NuScenesSequenceDataset
    from ..entry import resolve_device
    from ..eval.petr_runner import collect_and_evaluate_nusc, run_inference_petr
    from ..train.runner import run_petr_training
    from ..utils.synthetic import make_learnable_nusc_dataset

    device = resolve_device(device)
    os.makedirs(work, exist_ok=True)
    ann = os.path.join(work, 'infos.pkl')
    cfg, tcfg = build_configs(iters, lr, eval_every)
    tcfg = dataclasses.replace(tcfg, seed=seed)
    if dropout is not None:
        cfg = dataclasses.replace(cfg, dropout=dropout)
    make_learnable_nusc_dataset(ann, work, seed=seed, src_hw=cfg.input_hw,
                                image_format=image_format)
    host_cfg = host_config(cfg)
    train_ds = NuScenesSequenceDataset(ann, work, seq_split_num=2)
    eval_ds = NuScenesSequenceDataset(ann, work, seq_split_num=1)

    curve = []
    curve_path = os.path.join(work, 'curve.jsonl')

    def eval_fn(state):
        loader = EvalLoader(eval_ds, host_cfg, num_threads=2, device=device)
        results = run_inference_petr(cfg, state.model, loader, device=device)
        _, means = collect_and_evaluate_nusc(eval_ds, results)
        rec = {'iter': state.step, 'mAP': float(means['mAP']),
               'NDS': float(means['NDS'])}
        print('EVAL', json.dumps(rec), flush=True)
        curve.append(rec)
        with open(curve_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    loader = TrainLoader(train_ds, host_cfg, batch_size=batch, seed=seed,
                         num_threads=2, device=device)
    try:
        state = run_petr_training(cfg, tcfg, loader, work, batch,
                                  resume=False, max_iters=iters,
                                  eval_fn=eval_fn, device=device)
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
    if not curve[-1]['mAP'] >= GATE['final_map']:
        out.append(f"final mAP {curve[-1]['mAP']:.4f} < {GATE['final_map']}")
    if not curve[-1]['NDS'] >= GATE['final_nds']:
        out.append(f"final NDS {curve[-1]['NDS']:.4f} < {GATE['final_nds']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--work', required=True)
    ap.add_argument('--iters', type=int, default=1500)
    ap.add_argument('--eval-every', type=int, default=500)
    ap.add_argument('--lr', type=float, default=2.5e-3)
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--dropout', type=float, default=None,
                    help="the decoder's dropout rate (default the tiny "
                         "config's 0.1). Dropout is drawn on the model's "
                         'device, so a seed is another run on another '
                         'device; at 0 the run is drawn alike on all')
    ap.add_argument('--image-format', choices=('png', 'jpg'), default='jpg',
                    help="the dataset's images: jpg (the JAX demo's files) or "
                         'png (the same pixels, lossless)')
    ap.add_argument('--device', default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         'on the CPU)')
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    curve = run_closed_loop_nusc(args.work, args.iters, args.eval_every,
                                 args.lr, args.batch, args.seed, args.device,
                                 args.dropout, args.image_format)
    wall = time.perf_counter() - t0
    failures = gate_failures(curve)
    print(json.dumps({'curve': curve, 'wall_s': wall, 'gate': GATE,
                      'gate_failures': failures}), flush=True)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
