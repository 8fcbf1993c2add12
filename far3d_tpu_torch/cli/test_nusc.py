"""StreamPETR nuScenes evaluation CLI of the port (the twin of
``tools/test_nusc.py``), one process on one card:

    python -m far3d_tpu_torch.cli.test_nusc --data-root data/nuscenes \\
        [--ann-file nuscenes2d_temporal_infos_val.pkl] \\
        (--checkpoint work_dirs/streampetr | --random-init) \\
        [--quant [--quant-calib-frames 8]]

--checkpoint restores the latest train state that ``cli.train_nusc`` saved
in that directory; --random-init evaluates seeded random weights (a
pipeline smoke). --quant serves with the int8 backbone (``ops/quant.py``),
calibrated on the first --quant-calib-frames frames. Prints the nuScenes
metrics (mAP, the true-positive errors, NDS) per class.
"""

from __future__ import annotations

import argparse
import sys


def evaluate(argv=None):
    """Parse the command line and evaluate -> {'means': the nuScenes means,
    'summary': per class, 'frames': frames evaluated}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--ann-file', default=None)
    p.add_argument('--checkpoint', default=None,
                   help='work dir of cli.train_nusc (its latest checkpoint)')
    p.add_argument('--random-init', action='store_true',
                   help='evaluate seeded random weights (pipeline smoke)')
    p.add_argument('--src-wh', type=int, nargs=2, default=(1600, 900),
                   help='source camera resolution (W H)')
    p.add_argument('--max-frames', type=int, default=None)
    p.add_argument('--quant', action='store_true',
                   help='int8 PTQ backbone serving mode (ops/quant.py): '
                        'calibrate on the first --quant-calib-frames frames, '
                        'then evaluate with the quantized backbone')
    p.add_argument('--quant-calib-frames', type=int, default=8)
    p.add_argument('--set', dest='overrides', action='append', default=[],
                   metavar='KEY=VAL',
                   help='dotted StreamPETRConfig overrides')
    p.add_argument('--tiny', action='store_true',
                   help='tiny StreamPETR config (for fixture runs)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run "
                        'on the CPU)')
    args = p.parse_args(argv)
    if not (args.checkpoint or args.random_init):
        p.error('need --checkpoint or --random-init')

    from ..config import TrainConfig, apply_overrides
    from ..data.loader import EvalLoader
    from ..data.nuscenes_dataset import NuScenesSequenceDataset
    from ..entry import build_petr_model, resolve_device
    from ..eval.petr_runner import (collect_and_evaluate_nusc,
                                    petr_host_config, run_inference_petr)
    from ..models.streampetr import StreamPETRConfig, tiny_petr_config
    from ..train.petr_step import create_petr_train_state
    from ..utils.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    cfg = tiny_petr_config() if args.tiny else StreamPETRConfig()
    cfg = apply_overrides(cfg, args.overrides)
    ann = args.ann_file or \
        f'{args.data_root}/nuscenes2d_temporal_infos_val.pkl'
    dataset = NuScenesSequenceDataset(ann, args.data_root, seq_split_num=1)
    host_cfg = petr_host_config(cfg, tuple(args.src_wh))

    model = build_petr_model(cfg, device)
    if args.checkpoint:
        state, _ = create_petr_train_state(model, TrainConfig())
        if CheckpointManager(args.checkpoint).restore(state) is None:
            raise SystemExit(f'no checkpoint in {args.checkpoint}')
        print(f'restored step {state.step} from {args.checkpoint}')

    quant_tree = None
    if args.quant:
        from ..ops.quant import quantize_petr_backbone
        calib = [f['images'][None] for f in EvalLoader(
            dataset, host_cfg, max_frames=args.quant_calib_frames,
            device=device)]
        quant_tree = quantize_petr_backbone(model, calib)
        print(f'int8 PTQ backbone: calibrated on {len(calib)} frames')

    loader = EvalLoader(dataset, host_cfg, max_frames=args.max_frames,
                        device=device)
    results = run_inference_petr(cfg, model, loader, device=device,
                                 quant_tree=quant_tree)
    summary, means = collect_and_evaluate_nusc(dataset, results)
    return dict(means=means, summary=summary, frames=len(results))


def main(argv=None):
    evaluate(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
