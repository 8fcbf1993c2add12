"""The run's guards: the check for JAX and the JAX package by whole
top-level module names, and a run on a machine without a card."""

import json
import os
import subprocess
import sys

import pb_tiny
from harness import importcheck


def test_import_check_compares_whole_top_level_names():
    assert importcheck.forbidden_modules(['jax.numpy', 'numpy']) == ['jax']
    assert importcheck.forbidden_modules(['far3d_tpu.models.detector']) == \
        ['far3d_tpu']
    assert importcheck.forbidden_modules(
        ['far3d_tpu_torch', 'far3d_tpu_torch.ops.msda', 'jaxtyping',
         'flaxen', 'torch']) == []
    assert importcheck.forbidden_modules(['flax.linen', 'jaxlib.xla_client']) \
        == ['flax', 'jaxlib']


def test_the_harness_and_the_port_load_no_jax():
    code = ('import sys; sys.path[:0] = [%r, %r]; '
            'import drivers.stream, drivers.train, harness.family, '
            'far3d_tpu_torch.entry; from harness import importcheck; '
            'print(importcheck.forbidden_modules())'
            % (str(pb_tiny.BENCH), str(pb_tiny.ROOT)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, str(pb_tiny.BENCH / 'run.py'), '--workload',
         'far3d_av2.stream_int8', '--seed', '1', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(pb_tiny.ROOT))
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert 'metrics' not in json.loads(line)
        except json.JSONDecodeError:
            pass
    assert 'frame_ms' not in out.stdout
