"""Bound the int8 backbone's accuracy cost with the closed loop (the twin of
``tools/quant_accuracy.py``): train the tiny model to a high mAP on the
learnable synthetic dataset (``cli.overfit_demo``), then evaluate the same
weights with the bf16 backbone and with the int8 backbone
(``ops/quant.py``, calibrated on the first --calib-frames frames) and report
the mAP and CDS of each and their deltas.

    python -m far3d_tpu_torch.cli.quant_accuracy --work /tmp/quant_acc \\
        [--iters 2000] [--calib-frames 8] [--device cpu]

Reuses a checkpoint already in --work; trains one otherwise. Prints one JSON
line {"bf16": {...}, "int8": {...}, "delta_mAP": ..., "delta_CDS": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--work', required=True)
    ap.add_argument('--iters', type=int, default=2000)
    ap.add_argument('--lr', type=float, default=2.5e-3)
    ap.add_argument('--calib-frames', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         'on the CPU)')
    args = ap.parse_args(argv)

    from ..data.av2_dataset import AV2SequenceDataset
    from ..data.loader import EvalLoader
    from ..entry import build_model, resolve_device
    from ..eval.runner import collect_and_evaluate, run_inference
    from ..ops.quant import quantize_detector_backbone
    from ..train.step import create_train_state
    from ..utils.checkpoint import CheckpointManager
    from .overfit_demo import build_config, run_closed_loop

    device = resolve_device(args.device)
    cfg = build_config(args.iters, eval_every=args.iters, lr=args.lr,
                       gt_depth_until=args.iters // 2)
    state, _ = create_train_state(cfg, build_model(cfg, device))
    if CheckpointManager(args.work).restore(state) is None:
        curve = run_closed_loop(args.work, args.iters, eval_every=args.iters,
                                lr=args.lr, gt_depth_until=args.iters // 2,
                                seed=args.seed, device=device)
        print('# trained:', curve[-1], file=sys.stderr)
        if CheckpointManager(args.work).restore(state) is None:
            raise SystemExit(f'no checkpoint in {args.work} after training')
    model = state.model.eval()

    eval_ds = AV2SequenceDataset(os.path.join(args.work, 'infos.pkl'),
                                 args.work, split='val', seq_split_num=1,
                                 test_mode=False)
    calib = [f['images'][None] for f in EvalLoader(
        eval_ds, cfg, max_frames=args.calib_frames, device=device)]
    quant_tree = quantize_detector_backbone(model, calib)

    report = {}
    for tag, tree in (('bf16', None), ('int8', quant_tree)):
        results = run_inference(cfg, model,
                                EvalLoader(eval_ds, cfg, device=device),
                                device=device, quant_tree=tree)
        _, means = collect_and_evaluate(
            cfg, eval_ds, os.path.join(args.work, f'results_{tag}'), 0, 1,
            results)
        report[tag] = {'mAP': round(float(means['mAP']), 4),
                       'CDS': round(float(means.get('CDS', 0.0)), 4)}
    for key in ('mAP', 'CDS'):
        report[f'delta_{key}'] = round(report['int8'][key]
                                       - report['bf16'][key], 4)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
