"""Streaming evaluation CLI of the port (the twin of ``tools/test.py``;
reference tools/test.py + dist_test.sh), one process on one card:

    python -m far3d_tpu_torch.cli.test --data-root data/av2 \\
        --checkpoint work_dirs/far3d [--torch-checkpoint iter_82548.pth] \\
        [--eval-range-m 150]

--checkpoint restores the latest train state that ``cli.train`` saved in
that directory; --torch-checkpoint loads a reference ``.pth`` by key, since
the port's parameter names are the reference's. Prints the AV2 metrics
(mAP, CDS and the true-positive errors) per class. Not ported: the HD-map
ROI gate (--map-root), the feather submission (--submission), the int8
backbone (--quant) and several processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--ann-file', default=None)
    p.add_argument('--checkpoint', default=None,
                   help='work dir of cli.train (its latest checkpoint)')
    p.add_argument('--torch-checkpoint', default=None,
                   help='reference .pth to evaluate')
    p.add_argument('--results-dir', default='work_dirs/far3d/results')
    p.add_argument('--eval-range-m', type=float, default=None)
    p.add_argument('--use-ema', action='store_true',
                   help='evaluate the EMA shadow from the checkpoint '
                        '(needs training with train.ema_decay > 0)')
    p.add_argument('--set', dest='overrides', action='append', default=[],
                   metavar='KEY=VALUE',
                   help='config override, e.g. --set depthnet.num_depth_bins=30 '
                        '(reference --cfg-options)')
    p.add_argument('--tiny', action='store_true',
                   help='tiny test config (for fixture runs)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run "
                        'on the CPU)')
    args = p.parse_args(argv)
    if not (args.checkpoint or args.torch_checkpoint):
        p.error('need --checkpoint or --torch-checkpoint')

    from ..config import Far3DConfig, apply_overrides, tiny_test_config
    from ..data.av2_dataset import AV2SequenceDataset
    from ..data.loader import EvalLoader
    from ..entry import build_model, resolve_device
    from ..eval.runner import collect_and_evaluate, run_inference
    from ..train.step import create_train_state
    from ..utils.checkpoint import CheckpointManager
    from ..utils.convert import load_reference_checkpoint

    device = resolve_device(args.device)
    cfg = tiny_test_config() if args.tiny else Far3DConfig()
    cfg = apply_overrides(cfg, args.overrides)
    if args.use_ema:
        # build the state with its EMA slot so that the restore matches
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    ema_decay=0.999))
    ann = args.ann_file or f'{args.data_root}/av2_val_infos.pkl'
    dataset = AV2SequenceDataset(ann, args.data_root, split='val',
                                 interval_test=True, test_mode=False,
                                 seq_split_num=1)

    model = build_model(cfg, device)
    if args.torch_checkpoint:
        missing, _ = model.load_state_dict(
            load_reference_checkpoint(args.torch_checkpoint), strict=False)
        print(f'loaded {args.torch_checkpoint}; {len(missing)} missing')
    else:
        state, _ = create_train_state(cfg, model)
        if CheckpointManager(args.checkpoint).restore(state) is None:
            raise SystemExit(f'no checkpoint in {args.checkpoint}')
        print(f'restored step {state.step} from {args.checkpoint}')
        if args.use_ema:
            model.load_state_dict(state.ema, strict=False)

    loader = EvalLoader(dataset, cfg, device=device)
    results = run_inference(cfg, model, loader, device=device)
    collect_and_evaluate(cfg, dataset, args.results_dir, 0, 1, results,
                         eval_range_m=args.eval_range_m)
    return 0


if __name__ == '__main__':
    sys.exit(main())
