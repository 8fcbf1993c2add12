#!/usr/bin/env python3
"""The readings a cell's limits are set from: the compared numbers of the
program over many seeds, and of the cell's control over a few, in one
process so that set-up is paid once per seed and never for a build.

    python3 portbench/readings.py --workload far3d_av2.stream_int8 \
        --seeds 100-111 --control-seeds 200-202 --seconds 10 \
        --control-seconds 120

The control is named in ``portbench/limits/<cell>.json`` (``control``):
the reference at a lower integer range put in the program's place
(``{"qmax": 7}``, int4 for an int8 path), the program's own lower path
(``{"backbone": "int8"}`` for a bf16 one), or the reference with float8
convolutions in the program's place (``{"fp8": true}``, for a bf16 image
side in training). Prints one JSON line per run: the side, the seed and
the numbers. Needs the card its cell names.
"""

import argparse
import contextlib
import importlib
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import faults, spec  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(','):
        if '-' in part:
            a, b = part.split('-')
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--witness-seeds', default='',
                   help='training: seeds of the reference at the '
                   "configuration's own dtype in the program's place")
    p.add_argument('--fault-seeds', default='',
                   help='seeds of the program with --fault planted')
    p.add_argument('--fault', choices=('state_unchanged', 'answer_altered',
                                        'memory_unaligned', 'lift_moved'))
    p.add_argument('--control-seconds', type=float,
                   help="the control's window (default --seconds): long "
                   'enough that a slow control reaches every checked frame')
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(1)     # as run.py
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} CUDA card(s)', file=sys.stderr)
        return 3
    control = spec.load_json(BENCH / 'limits' / f'{cell.name}.json')['control']
    driver = importlib.import_module(f"drivers.{cell.traffic['kind']}")
    sides = {'program': None, 'control': control, 'witness': {'lower': False}}
    for side, group in (('program', seeds(args.seeds)),
                        ('control', seeds(args.control_seeds)),
                        ('witness', seeds(args.witness_seeds)),
                        ('fault', seeds(args.fault_seeds))):
        for seed in group:
            t0 = time.perf_counter()
            secs = (args.control_seconds or args.seconds
                    if side == 'control' else args.seconds)
            planted = (faults.plant(cell.traffic['kind'],
                                    cell.config['family'], args.fault)
                       if side == 'fault' else contextlib.nullcontext())
            with planted:
                out = driver.run(cell, seed, secs, False, t0,
                                 control=sides.get(side))
            print(json.dumps({'side': side if side != 'fault' else args.fault,
                              'seed': seed,
                              'numbers': out['numbers'],
                              'e2e': out['e2e'],
                              'seconds': time.perf_counter() - t0}),
                  flush=True)
            del out
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
