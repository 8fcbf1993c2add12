"""StreamPETR nuScenes training CLI of the port (the twin of
``tools/train_nusc.py``), one process a card:

    python -m far3d_tpu_torch.cli.train_nusc --data-root data/nuscenes \\
        [--ann-file nuscenes2d_temporal_infos_train.pkl] \\
        [--work-dir work_dirs/streampetr] [--max-iters N]
    torchrun --nproc_per_node 8 -m far3d_tpu_torch.cli.train_nusc ...

Reads ``nuscenes2d_temporal_infos_train.pkl`` from --data-root (or
--ann-file) through ``NuScenesSequenceDataset`` and the shared host pipeline
(PNG through the port's decoder; other formats only where OpenCV is
installed) and trains through ``train/runner.py``'s loop: a log line every
--log-interval steps, a checkpoint of the whole train state every
--ckpt-interval steps and at the last, a resume from the latest one in
--work-dir unless --no-resume. Under torchrun, Slurm or the ``FAR3D_*``
variables (``parallel/mesh.py:init_distributed``) the processes train
data-parallel, each with --batch-size lanes of the global batch, as
``cli.train`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data-root', required=True)
    p.add_argument('--ann-file', default=None)
    p.add_argument('--work-dir', default='work_dirs/streampetr')
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--max-iters', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--src-wh', type=int, nargs=2, default=(1600, 900))
    p.add_argument('--log-interval', type=int, default=50)
    p.add_argument('--ckpt-interval', type=int, default=2000)
    p.add_argument('--no-resume', action='store_true')
    p.add_argument('--set', dest='overrides', action='append', default=[],
                   metavar='KEY=VAL',
                   help='dotted StreamPETRConfig overrides, e.g. '
                        '--set num_layers=2')
    p.add_argument('--tiny', action='store_true',
                   help='tiny StreamPETR config (for fixture runs)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run "
                        'on the CPU)')
    args = p.parse_args(argv)

    from ..config import TrainConfig, apply_overrides
    from ..data.loader import TrainLoader
    from ..data.nuscenes_dataset import NuScenesSequenceDataset
    from ..entry import resolve_device
    from ..eval.petr_runner import petr_host_config
    from ..models.streampetr import StreamPETRConfig, tiny_petr_config
    from ..parallel import mesh
    from ..train.runner import run_petr_training

    rank, world = mesh.init_distributed(args.device)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format='%(asctime)s %(levelname)s %(message)s')
    cfg = tiny_petr_config() if args.tiny else StreamPETRConfig()
    cfg = apply_overrides(cfg, args.overrides)
    tcfg = dataclasses.replace(
        TrainConfig(), seed=args.seed, log_every=args.log_interval,
        checkpoint_every=args.ckpt_interval)
    if args.max_iters:
        tcfg = dataclasses.replace(tcfg, total_iters=args.max_iters)

    ann = args.ann_file or \
        f'{args.data_root}/nuscenes2d_temporal_infos_train.pkl'
    dataset = NuScenesSequenceDataset(ann, args.data_root, seq_split_num=2)
    loader = TrainLoader(dataset, petr_host_config(cfg, tuple(args.src_wh)),
                         args.batch_size, rank=rank, world_size=world,
                         seed=args.seed, device=device)
    Path(args.work_dir).mkdir(parents=True, exist_ok=True)
    try:
        run_petr_training(cfg, tcfg, loader, args.work_dir, args.batch_size,
                          resume=not args.no_resume, max_iters=args.max_iters,
                          device=device)
    finally:
        loader.stop()
        mesh.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
