"""What decides ``correct``, at the tiny configurations on the CPU: the
frozen reference against the port, a sound run that passes the cells'
limits, each cell's control and each fault a cell can have, which fail
them. The same runs as on the card (``drivers/*.run`` past the harness's
look for a card), at sizes a test run holds."""

import time

import pytest
import torch

import pb_tiny
from harness import compare, family, faults

SECONDS = 2.0
SEED = 2 ** 31 + 99


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp('checkout'))


def judged(root, name, control=None, seed=SEED):
    import importlib
    cell = pb_tiny.tiny_cell(root, name)
    driver = importlib.import_module(f"drivers.{cell.traffic['kind']}")
    out = driver.run(cell, seed, SECONDS, False, time.perf_counter(),
                     device='cpu', control=control)
    ok, rows = compare.judge(out['numbers'],
                             pb_tiny.limits(name)['limits'])
    return ok, rows, out


@pytest.mark.parametrize('config', ['far3d_av2', 'streampetr_nusc'])
def test_reference_computes_the_ports_float32_frame(root, config):
    """On the CPU the port runs its plain versions too, so in float32 the
    two agree to rounding on the same weights, frame and state."""
    cfg_json = pb_tiny.spec.load_json(root / 'portbench' / 'configs'
                                      / f'{config}.json')
    port, ref = (family.load(cfg_json, s) for s in ('port', 'reference'))
    weights = port.weights(SEED, 'cpu')
    pm, rm = port.build(weights, 'cpu'), ref.build(weights, 'cpu')
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(1, port.num_cams, *port.input_hw, 3, generator=gen)
    batch = dict(images=images, prev_exists=torch.zeros(1),
                 timestamp=torch.zeros(1), ego_pose=torch.eye(4)[None],
                 ego_pose_inv=torch.eye(4)[None], **port.rig('cpu'))
    p_out = port.forward(pm, port.init_state('cpu'), batch)
    r_out = ref.forward(rm, ref.init_state('cpu'), batch)
    for a, b in zip(p_out[:3], r_out[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(p_out[3].embedding, r_out[3].embedding,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('name', list(pb_tiny.TINY))
def test_sound_run_is_correct(root, name):
    ok, rows, out = judged(root, name)
    assert ok, rows


@pytest.mark.parametrize('name', list(pb_tiny.TINY))
def test_control_is_not_correct(root, name):
    ok, rows, _ = judged(root, name, control=pb_tiny.limits(name)['control'])
    assert not ok, rows


FAULTS = ([(name, fault) for name in pb_tiny.TINY
           for fault in ('state_unchanged', 'answer_altered')]
          + [('far3d_av2.stream_int8', 'memory_unaligned'),
             ('streampetr_nusc.stream_bf16', 'memory_unaligned'),
             ('far3d_av2.stream_int8', 'lift_moved')])


@pytest.mark.parametrize('name,fault', FAULTS)
def test_faults_are_not_correct(root, name, fault):
    cell = pb_tiny.tiny_cell(root, name)
    with faults.plant(cell.traffic['kind'], cell.config['family'], fault):
        ok, rows, _ = judged(root, name)
    assert not ok, rows
