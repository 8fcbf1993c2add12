"""Camera-sharded inference of the port (far3d_tpu_torch/parallel/cam_shard.py)
against the JAX package's ``make_cam_sharded_infer`` on its 2-device CPU
mesh, the twins of tests/test_cam_shard.py:40-80: the tiny config's two
cameras over ``['cpu', 'cpu']``, one camera a slice, on shared weights.

Two streamed frames (a fresh start, then the carried state): the port's
sharded frame against the JAX sharded frame and against its own unsharded
one, both at test_cam_shard.py's tolerances (scores and the carried state
rtol = atol = 1e-4, boxes 1e-3; the differences measured on the CPU are
below 1.2e-7 in the scores and 5e-6 in the boxes and the state).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_setup import make_cfgs, port_model, shared_weights, to_np
from far3d_tpu.models.detector import Far3D as JaxFar3D
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.parallel.cam_shard import make_cam_mesh
from far3d_tpu.parallel.cam_shard import \
    make_cam_sharded_infer as jax_cam_sharded_infer
from far3d_tpu_torch.entry import run_frame
from far3d_tpu_torch.models.farhead import init_state as torch_init_state
from far3d_tpu_torch.parallel.cam_shard import (cam_splits,
                                                make_cam_sharded_infer)
from test_torch_port_model import _frames

SHARD_TOL = {'scores': dict(rtol=1e-4, atol=1e-4),
             'boxes': dict(rtol=1e-3, atol=1e-3),
             'embedding': dict(rtol=1e-4, atol=1e-4)}


@pytest.fixture(scope='module')
def runs():
    jax_cfg, port_cfg = make_cfgs()
    assert port_cfg.data.num_cams == 2
    variables, sd = shared_weights(jax_cfg, port_cfg)
    model = port_model(port_cfg, sd)
    jrun = jax_cam_sharded_infer(JaxFar3D(jax_cfg), jax_cfg,
                                 make_cam_mesh(jax_cfg.data.num_cams))
    trun = make_cam_sharded_infer(model, port_cfg, ['cpu', 'cpu'])
    seen = []
    hook = model.img_backbone.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    js = jax_init_state(1, jax_cfg.head)
    ts = us = torch_init_state(1, port_cfg.head, 'cpu')
    out = []
    for f in _frames(jax_cfg):
        jd, js = jrun(variables, js, {k: jnp.asarray(v) for k, v in f.items()})
        kw = {k: torch.from_numpy(np.array(v)) for k, v in f.items()}
        td, ts = trun(ts, kw)
        ud, us = run_frame(model, us, **kw)
        out.append(dict(jax=(jd, js), sharded=(td, ts), unsharded=(ud, us)))
    hook.remove()
    return dict(frames=out, run=trun, seen=seen, cfg=port_cfg)


@pytest.mark.parametrize('frame', range(2))
def test_cam_sharded_matches_unsharded(runs, frame):
    f = runs['frames'][frame]
    (td, ts), (ud, us) = f['sharded'], f['unsharded']
    for k in ('scores', 'boxes'):
        np.testing.assert_allclose(to_np(td[k]), to_np(ud[k]), err_msg=k,
                                   **SHARD_TOL[k])
    assert torch.equal(td['labels'], ud['labels'])
    np.testing.assert_allclose(to_np(ts.embedding), to_np(us.embedding),
                               **SHARD_TOL['embedding'])
    assert np.isfinite(to_np(td['scores'])).all()


@pytest.mark.parametrize('frame', range(2))
def test_cam_sharded_matches_jax_cam_sharded(runs, frame):
    f = runs['frames'][frame]
    (jd, js), (td, ts) = f['jax'], f['sharded']
    for k in ('scores', 'boxes'):
        np.testing.assert_allclose(to_np(td[k]), np.asarray(jd[k]),
                                   err_msg=k, **SHARD_TOL[k])
    assert np.array_equal(to_np(td['labels']), np.asarray(jd['labels']))
    assert np.array_equal(to_np(td['valid']), np.asarray(jd['valid']))
    for field in ('embedding', 'ref_points', 'timestamp', 'egopose', 'velo'):
        np.testing.assert_allclose(to_np(getattr(ts, field)),
                                   np.asarray(getattr(js, field)),
                                   err_msg=field, **SHARD_TOL['embedding'])


def test_each_device_slice_holds_one_camera(runs):
    cfg = runs['cfg']
    h, w = cfg.data.input_hw
    assert [s for _, s in runs['run'].slices] == [(0, 1), (1, 2)]
    assert all(d == torch.device('cpu') for d, _ in runs['run'].slices)
    # per frame: one backbone call a camera slice (1 image each), then the
    # unsharded frame's call on both cameras
    assert runs['seen'] == [(1, 3, h, w), (1, 3, h, w), (2, 3, h, w)] * 2


def test_cam_splits_and_device_count():
    assert cam_splits(7, 7) == [(i, i + 1) for i in range(7)]
    assert cam_splits(7, 3) == [(0, 3), (3, 5), (5, 7)]
    _, cfg = make_cfgs()
    with pytest.raises(ValueError, match='needs >= 2 devices'):
        make_cam_sharded_infer(None, cfg, ['cpu'])
