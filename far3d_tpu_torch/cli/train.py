"""Training CLI of the port (the twin of ``tools/train.py``; reference
tools/train.py + dist_train.sh), one process a card:

    python -m far3d_tpu_torch.cli.train --data-root data/av2 \\
        --work-dir work_dirs/far3d [--val-ann-file data/av2/av2_val_infos.pkl]
    torchrun --nproc_per_node 8 -m far3d_tpu_torch.cli.train ...

Reads ``av2_train_infos.pkl`` from --data-root (or --ann-file); the images
are decoded by ``data/image_io.py``, which reads PNG and reads other formats
only through OpenCV where it is installed. Checkpoints and ``metrics.jsonl``
go to --work-dir; a run there resumes from its latest checkpoint unless
--no-resume. Under torchrun, Slurm or ``cli/dist_train.sh`` the processes
train data-parallel (``parallel/mesh.py:init_distributed``), each on its
card over NCCL with --batch-size lanes of the global batch, or with
--device cpu on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import sys
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--ann-file', default=None)
    p.add_argument('--work-dir', default='work_dirs/far3d')
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--max-iters', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--no-resume', action='store_true')
    p.add_argument('--load-from', default=None,
                   help='reference .pth to load by key (e.g. the FCOS3D '
                        'VoVNet backbone pretrain, far3d.py:284)')
    p.add_argument('--profile-at', type=int, default=None)
    p.add_argument('--set', dest='overrides', action='append', default=[],
                   metavar='KEY=VALUE',
                   help='config override, e.g. --set head.dn_groups=8 '
                        '--set train.lr=1e-4 (reference --cfg-options)')
    p.add_argument('--val-ann-file', default=None,
                   help='val info pkl; enables eval-during-training every '
                        'checkpoint interval (reference CustomDistEvalHook, '
                        'eval_hooks.py:29-91)')
    p.add_argument('--eval-samples', type=int, default=None,
                   help='cap val frames per in-training eval')
    p.add_argument('--tiny', action='store_true',
                   help='tiny test config (for fixture runs)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run "
                        'on the CPU)')
    args = p.parse_args(argv)

    from ..config import Far3DConfig, apply_overrides, tiny_test_config
    from ..data.av2_dataset import AV2SequenceDataset
    from ..data.loader import TrainLoader
    from ..entry import resolve_device
    from ..parallel import mesh
    from ..train.runner import run_training

    rank, world = mesh.init_distributed(args.device)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format='%(asctime)s %(levelname)s %(message)s')
    cfg = tiny_test_config() if args.tiny else Far3DConfig()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=args.seed))
    cfg = apply_overrides(cfg, args.overrides)

    ann = args.ann_file or f'{args.data_root}/av2_train_infos.pkl'
    dataset = AV2SequenceDataset(ann, args.data_root, split='train',
                                 seq_split_num=cfg.data.seq_split_num)
    loader = TrainLoader(dataset, cfg, args.batch_size, rank=rank,
                         world_size=world, seed=args.seed, device=device)
    Path(args.work_dir).mkdir(parents=True, exist_ok=True)

    eval_fn = None
    if args.val_ann_file:
        eval_fn = build_eval_fn(cfg, args.val_ann_file, args.data_root,
                                args.work_dir, device, rank, world,
                                max_frames=args.eval_samples)
    try:
        run_training(cfg, loader, args.work_dir, args.batch_size,
                     resume=not args.no_resume, max_iters=args.max_iters,
                     profile_at=args.profile_at, load_from=args.load_from,
                     eval_fn=eval_fn, device=device)
    finally:
        loader.stop()
        mesh.shutdown()
    return 0


def build_eval_fn(cfg, val_ann, data_root, work_dir, device, rank=0,
                  world=1, max_frames=None):
    """Eval-during-training (reference CustomDistEvalHook._do_evaluate,
    core/evaluation/eval_hooks.py:54-91): each rank streams its val shard
    through the current weights (the EMA shadow when the state has one);
    rank 0 logs the AV2 metrics to ``eval_metrics.jsonl``."""
    from ..data.av2_dataset import AV2SequenceDataset
    from ..data.loader import EvalLoader
    from ..eval.runner import collect_and_evaluate, run_inference

    # with its GT (the JAX tool passes test_mode=True, so its in-training
    # eval has no annotations to score against)
    val_ds = AV2SequenceDataset(val_ann, data_root, split='val',
                                seq_split_num=1)
    loader = EvalLoader(val_ds, cfg, rank=rank, world_size=world,
                        max_frames=max_frames, device=device)
    log = logging.getLogger('far3d_tpu_torch.eval')

    def eval_fn(state):
        model = state.model
        if state.ema is not None:
            model = copy.deepcopy(model)
            model.load_state_dict(state.ema, strict=False)
        results = run_inference(cfg, model, loader, device=device)
        out = collect_and_evaluate(
            cfg, val_ds, f'{work_dir}/eval_step{state.step}', rank, world,
            results)
        if out is None:
            return
        _, means = out
        log.info('eval @ step %d: %s', state.step, means)
        with open(f'{work_dir}/eval_metrics.jsonl', 'a') as f:
            f.write(json.dumps({'step': state.step, **means}) + '\n')

    return eval_fn


if __name__ == '__main__':
    sys.exit(main())
