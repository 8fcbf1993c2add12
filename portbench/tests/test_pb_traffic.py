"""The traffic generator: equal seeds give equal inputs, other seeds other
inputs of the same sizes; seeds past 32 bits work."""

import numpy as np
import torch

import pb_tiny  # noqa: F401
from harness import spec, traffic as tr

BIG = 2 ** 31 + 12345


def mix(name):
    return spec.load_json(pb_tiny.BENCH / 'traffic' / f'{name}.json')


def frames(seed, n=12):
    s = tr.Stream(mix('av2_stream_int8'), seed)
    return [s.frame(i) for i in range(n)]


def same(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_stream_is_fixed_by_its_seed():
    assert same(frames(BIG), frames(BIG))
    assert not same(frames(BIG), frames(BIG + 1))
    pool = tr.image_pool(3, 2, (16, 24), BIG, 'cpu')
    assert torch.equal(pool, tr.image_pool(3, 2, (16, 24), BIG, 'cpu'))
    assert not torch.equal(pool, tr.image_pool(3, 2, (16, 24), BIG + 1, 'cpu'))
    assert pool.dtype == torch.uint8 and pool.shape == (3, 1, 2, 16, 24, 3)


def test_trajectory_drives_at_the_mix_speed_and_resets_scenes():
    t = mix('av2_stream_int8')
    fr = frames(5, t['scene_frames'] + 2)
    assert fr[0]['prev_exists'] == 0 and fr[1]['prev_exists'] == 1
    assert fr[t['scene_frames']]['prev_exists'] == 0
    step = np.linalg.norm(fr[2]['ego_pose'][:2, 3] - fr[1]['ego_pose'][:2, 3])
    lo, hi = t['speed_mps']
    assert lo * t['frame_dt_s'] - 1e-3 <= step <= hi * t['frame_dt_s'] + 1e-3
    assert np.allclose(fr[3]['ego_pose'] @ fr[3]['ego_pose_inv'], np.eye(4),
                       atol=1e-4)
    assert fr[4]['timestamp'] == np.float32(4 * t['frame_dt_s'])


def test_checked_frames_are_fixed_by_the_seed():
    t = mix('nusc_stream_bf16')
    a = tr.check_frames(t, BIG)
    assert a == tr.check_frames(t, BIG) and a != tr.check_frames(t, BIG + 7)
    assert len(a) == t['check_frames'] and a[0] == 0
    assert t['scene_frames'] in a and max(a) < t['check_within']


def test_training_batches_are_fixed_by_the_seed():
    from far3d_tpu_torch.config import tiny_test_config
    cfg = tiny_test_config()
    t = {'pool_batches': 2}
    a = tr.train_batches(cfg, t, BIG, 'cpu')
    b = tr.train_batches(cfg, t, BIG, 'cpu')
    c = tr.train_batches(cfg, t, BIG + 1, 'cpu')
    assert all(torch.equal(a[i][k], b[i][k]) for i in range(2) for k in a[i])
    assert not torch.equal(a[0]['gt_boxes'], c[0]['gt_boxes'])
    assert a[0]['images'].dtype == torch.uint8
    assert {k: v.shape for k, v in a[0].items()} == \
        {k: v.shape for k, v in c[0].items()}
