"""Helpers of the benchmark's CPU tests: a checkout in a temporary
directory whose ``BENCHMARK.json`` names the real cells' traffic and
limits over the port's tiny configurations, so that a whole run fits on
the CPU."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import spec  # noqa: E402

LINKED = ('harness', 'drivers', 'families', 'metrics', 'kernels',
          'reference', 'traffic', 'limits', 'run.py')
# the real cells and the tiny configuration each runs on here
TINY = {'far3d_av2.stream_int8': 'far3d_av2',
        'streampetr_nusc.stream_bf16': 'streampetr_nusc',
        'far3d_av2.train': 'far3d_av2'}


def tiny_configs():
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.models.streampetr import tiny_petr_config
    return {'far3d_av2': ('far3d', tiny_test_config()),
            'streampetr_nusc': ('streampetr', tiny_petr_config())}


def tiny_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout under `tmp`: the benchmark's folders linked, the program
    linked, the configuration files replaced by the tiny configurations
    under the same names."""
    (tmp / 'portbench' / 'configs').mkdir(parents=True)
    for name in LINKED:
        (tmp / 'portbench' / name).symlink_to(BENCH / name)
    (tmp / 'far3d_tpu_torch').symlink_to(ROOT / 'far3d_tpu_torch')
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for name, (family, cfg) in tiny_configs().items():
        real = json.loads((BENCH / 'configs' / f'{name}.json').read_text())
        real['model'] = dataclasses.asdict(cfg)
        (tmp / 'portbench' / 'configs' / f'{name}.json').write_text(
            json.dumps(real))
    (tmp / 'BENCHMARK.json').write_text(json.dumps(bench))
    return tmp


def tiny_cell(root: pathlib.Path, name: str):
    """The cell with its traffic shortened to what a CPU run holds: three
    checked frames among the first twelve, scenes of six frames (so one
    of them carries the memory of a scene)."""
    cell = spec.find_cell(name, root)
    t = dict(cell.traffic)
    if t['kind'] == 'stream':
        t.update(check_within=12, check_frames=3, scene_frames=6,
                 warmup_frames=2, pool_frames=4)
    else:
        t.update(pool_batches=2)
    cell.traffic = t
    return cell


def limits(name: str):
    return spec.load_json(BENCH / 'limits' / f'{name}.json')
