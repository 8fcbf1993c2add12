"""Streaming evaluation CLI of the port (the twin of ``tools/test.py``;
reference tools/test.py + dist_test.sh), one process a card:

    python -m far3d_tpu_torch.cli.test --data-root data/av2 \\
        --checkpoint work_dirs/far3d [--torch-checkpoint iter_82548.pth] \\
        [--eval-range-m 150] [--map-root data/av2] \\
        [--submission out.feather] [--quant [--quant-calib-frames 8]]

--checkpoint restores the latest train state that ``cli.train`` saved in
that directory; --torch-checkpoint loads a reference ``.pth`` by key, since
the port's parameter names are the reference's. --map-root gates the
metric with the HD map's drivable-area ROI (``eval/map_roi.py``),
--submission writes the AV2 Feather submission, and --quant serves with the
int8 backbone (``ops/quant.py``), calibrated on the first
--quant-calib-frames frames. Prints the AV2 metrics (mAP, CDS and the
true-positive errors) per class. Under torchrun, Slurm or
``cli/dist_test.sh`` (``parallel/mesh.py:init_distributed``) each rank
streams its contiguous shard of the val set and writes its part file; rank
0 concatenates the parts in rank order, scores them and writes the
submission of every rank's frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def evaluate(argv=None):
    """Parse the command line and evaluate -> {'means': the AV2 means,
    'summary': per class, 'frames': frames evaluated, 'submission_rows':
    rows written or None}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--ann-file', default=None)
    p.add_argument('--checkpoint', default=None,
                   help='work dir of cli.train (its latest checkpoint)')
    p.add_argument('--torch-checkpoint', default=None,
                   help='reference .pth to evaluate')
    p.add_argument('--results-dir', default='work_dirs/far3d/results')
    p.add_argument('--eval-range-m', type=float, default=None)
    p.add_argument('--map-root', default=None,
                   help='AV2 sensor-data root holding {log_id}/map/ dirs; '
                        'enables the HD-map ROI gate (av2_eval_util.py:'
                        '158-318)')
    p.add_argument('--submission', default=None,
                   help='AV2 Feather submission output path')
    p.add_argument('--use-ema', action='store_true',
                   help='evaluate the EMA shadow from the checkpoint '
                        '(needs training with train.ema_decay > 0)')
    p.add_argument('--set', dest='overrides', action='append', default=[],
                   metavar='KEY=VALUE',
                   help='config override, e.g. --set depthnet.num_depth_bins=30 '
                        '(reference --cfg-options)')
    p.add_argument('--tiny', action='store_true',
                   help='tiny test config (for fixture runs)')
    p.add_argument('--quant', action='store_true',
                   help='int8 PTQ backbone serving mode (ops/quant.py): '
                        'calibrate on the first --quant-calib-frames frames, '
                        'then evaluate with the quantized backbone')
    p.add_argument('--quant-calib-frames', type=int, default=8)
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
    from ..eval.runner import (collect_parts, evaluate_parts,
                               format_av2_submission, run_inference)
    from ..parallel import mesh
    from ..train.step import create_train_state
    from ..utils.checkpoint import CheckpointManager
    from ..utils.convert import load_reference_checkpoint

    rank, world = mesh.init_distributed(args.device)
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

    roi_masks = None
    if args.map_root:
        from ..eval.map_roi import build_roi_masks
        roi_masks = build_roi_masks(dataset, args.map_root)
        print('HD-map ROI gate:',
              'enabled' if roi_masks is not None else
              'no map dirs found, falling back to range gating')

    quant_tree = None
    if args.quant:
        from ..ops.quant import quantize_detector_backbone
        calib = [f['images'][None] for f in EvalLoader(
            dataset, cfg, max_frames=args.quant_calib_frames, device=device)]
        quant_tree = quantize_detector_backbone(model, calib)
        print(f'int8 PTQ backbone: calibrated on {len(calib)} frames')

    loader = EvalLoader(dataset, cfg, rank=rank, world_size=world,
                        device=device)
    results = run_inference(cfg, model, loader, device=device,
                            quant_tree=quant_tree)
    parts = collect_parts(args.results_dir, rank, world, results)
    if parts is None:        # a rank other than 0: its part is written
        return dict(means=None, summary=None, frames=len(results),
                    submission_rows=None)
    # every rank's frames (the JAX tool scores them, and writes rank 0's
    # alone to the submission)
    results = parts
    summary, means = evaluate_parts(cfg, dataset, results,
                                    eval_range_m=args.eval_range_m,
                                    roi_masks=roi_masks)
    rows = None
    if args.submission:
        from ..config import AV2_CLASS_NAMES
        from ..utils.feather import write_feather
        rows = write_feather(args.submission,
                             format_av2_submission(results, AV2_CLASS_NAMES))
        print(f'wrote submission: {args.submission} ({rows} rows)')
    return dict(means=means, summary=summary, frames=len(results),
                submission_rows=rows)


def main(argv=None):
    from ..parallel import mesh
    try:
        evaluate(argv)
    finally:
        mesh.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
