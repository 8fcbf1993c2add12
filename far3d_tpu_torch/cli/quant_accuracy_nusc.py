"""Bound the int8 backbone's accuracy cost on StreamPETR with the closed
loop (the twin of ``tools/quant_accuracy_nusc.py``): train the tiny
StreamPETR to a high mAP on the learnable synthetic nuScenes dataset
(``cli.overfit_nusc_demo``), then evaluate the same weights with the bf16
and with the int8 backbone (``ops/quant.py:quantize_petr_backbone``,
calibrated on the first --calib-frames frames) and report mAP and NDS of
each and their deltas.

    python -m far3d_tpu_torch.cli.quant_accuracy_nusc --work /tmp/qn \\
        [--iters 2500] [--calib-frames 8] [--device cpu]

Reuses a checkpoint already in --work; trains one otherwise. Prints one JSON
line {"bf16": {...}, "int8": {...}, "delta_mAP": ..., "delta_NDS": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--work', required=True)
    ap.add_argument('--iters', type=int, default=2500)
    ap.add_argument('--lr', type=float, default=2.5e-3)
    ap.add_argument('--calib-frames', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         'on the CPU)')
    args = ap.parse_args(argv)

    from ..data.loader import EvalLoader
    from ..data.nuscenes_dataset import NuScenesSequenceDataset
    from ..entry import build_petr_model, resolve_device
    from ..eval.petr_runner import collect_and_evaluate_nusc, run_inference_petr
    from ..ops.quant import quantize_petr_backbone
    from ..train.petr_step import create_petr_train_state
    from ..utils.checkpoint import CheckpointManager
    from .overfit_nusc_demo import (build_configs, host_config,
                                    run_closed_loop_nusc)

    device = resolve_device(args.device)
    cfg, tcfg = build_configs(args.iters, args.lr, eval_every=args.iters)
    state, _ = create_petr_train_state(build_petr_model(cfg, device), tcfg)
    if CheckpointManager(args.work).restore(state) is None:
        curve = run_closed_loop_nusc(args.work, args.iters,
                                     eval_every=args.iters, lr=args.lr,
                                     seed=args.seed, device=device)
        print('# trained:', curve[-1], file=sys.stderr)
        if CheckpointManager(args.work).restore(state) is None:
            raise SystemExit(f'no checkpoint in {args.work} after training')
    model = state.model.eval()

    host_cfg = host_config(cfg)
    eval_ds = NuScenesSequenceDataset(os.path.join(args.work, 'infos.pkl'),
                                      args.work, seq_split_num=1)
    calib = [f['images'][None] for f in EvalLoader(
        eval_ds, host_cfg, max_frames=args.calib_frames, device=device)]
    quant_tree = quantize_petr_backbone(model, calib)

    report = {}
    for tag, tree in (('bf16', None), ('int8', quant_tree)):
        results = run_inference_petr(
            cfg, model, EvalLoader(eval_ds, host_cfg, device=device),
            device=device, quant_tree=tree)
        _, means = collect_and_evaluate_nusc(eval_ds, results)
        report[tag] = {'mAP': round(float(means['mAP']), 4),
                       'NDS': round(float(means['NDS']), 4)}
    for key in ('mAP', 'NDS'):
        report[f'delta_{key}'] = round(report['int8'][key]
                                       - report['bf16'][key], 4)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
