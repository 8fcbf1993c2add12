"""The deterministic eval augmentation's metric deviation, measured by the
port (the twin of ``tools/eval_aug_delta.py``; docs/PARITY.md).

The reference samples a random resize/crop at eval time
(custom_pipeline.py:313-326 runs the same sampler for train and test); the
pipeline fixes the midpoint resize and centre crop (``data/pipeline.py``).
This tool evaluates one trained checkpoint on the same frames under (a) the
deterministic eval pipeline and (b) --seeds seeds of the reference-style
random resize/crop, and prints the mAP/CDS spread. The random draws come
from ``np.random.default_rng(1000 + seed)``, as the JAX tool's, taken in
frame order (the loader reads with one thread here).

    python -m far3d_tpu_torch.cli.eval_aug_delta --work /tmp/overfit \\
        [--seeds 3] [--checkpoint DIR | --torch-checkpoint iter.pth] \\
        [--full-config] [--device cpu]

--work is a ``cli.overfit_demo`` work dir: its dataset (``infos.pkl``) and
its latest checkpoint, or the weights of --checkpoint (a ``cli.train`` work
dir) or --torch-checkpoint. --full-config evaluates ``Far3DConfig()`` (for a
full-width checkpoint) in place of the demo's tiny config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock


def run(argv=None):
    """-> {'deterministic': {mAP, CDS}, 'random': [{mAP, CDS}] a seed,
    'summary': the printed spread}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--work', required=True,
                    help='overfit_demo work dir (dataset + checkpoint)')
    ap.add_argument('--seeds', type=int, default=3)
    ap.add_argument('--checkpoint', default=None,
                    help="work dir whose latest checkpoint to evaluate in "
                         "place of --work's")
    ap.add_argument('--torch-checkpoint', default=None,
                    help='reference .pth to evaluate in place of the work '
                         "dir's checkpoint")
    ap.add_argument('--full-config', action='store_true',
                    help="Far3DConfig() in place of the overfit demo's")
    ap.add_argument('--device', default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         'on the CPU)')
    args = ap.parse_args(argv)

    import numpy as np

    from ..config import Far3DConfig
    from ..data import pipeline as pl
    from ..data.av2_dataset import AV2SequenceDataset
    from ..data.loader import EvalLoader
    from ..entry import resolve_device
    from ..eval.runner import collect_and_evaluate, run_inference
    from ._common import load_model
    from .overfit_demo import build_config

    device = resolve_device(args.device)
    # must match the checkpoint: the overfit demo's, or full width
    cfg = Far3DConfig() if args.full_config else build_config(iters=1)
    ds = AV2SequenceDataset(os.path.join(args.work, 'infos.pkl'), args.work,
                            split='val', seq_split_num=1, test_mode=False)
    if not (args.checkpoint or args.torch_checkpoint):
        args.checkpoint = args.work
    model = load_model(cfg, args, device)

    def evaluate(tag):
        loader = EvalLoader(ds, cfg, num_threads=1, device=device)
        results = run_inference(cfg, model, loader, device=device)
        _, means = collect_and_evaluate(
            cfg, ds, os.path.join(args.work, f'results_{tag}'), 0, 1, results)
        return {'mAP': float(means['mAP']), 'CDS': float(means.get('CDS', 0))}

    det = evaluate('det')
    print('deterministic:', json.dumps(det))
    orig = pl.sample_augmentation
    rand = []
    for seed in range(args.seeds):
        hold = [np.random.default_rng(1000 + seed)]

        def random_aug(rng, dcfg, h, w, train, _orig=orig, _hold=hold):
            # reference-style: eval samples the training distribution
            return _orig(_hold[0], dcfg, h, w, True)

        with mock.patch.object(pl, 'sample_augmentation', random_aug):
            r = evaluate(f'rand{seed}')
        rand.append(r)
        print(f'random seed {seed}:', json.dumps(r))
    maps = [r['mAP'] for r in rand]
    summary = {
        'deterministic_mAP': det['mAP'],
        'random_mAP_mean': float(np.mean(maps)),
        'random_mAP_std': float(np.std(maps)),
        'delta_mAP': float(det['mAP'] - np.mean(maps)),
    }
    print(json.dumps(summary))
    return {'deterministic': det, 'random': rand, 'summary': summary}


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
