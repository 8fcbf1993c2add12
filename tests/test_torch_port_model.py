"""The whole tiny Far3D of the PyTorch port against the JAX package: two
streaming frames plus decode on shared weights, the reference key layout and
the weight carry-over, and the recorded JAX golden outputs."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import far3d_tpu.config as jcfg
import far3d_tpu_torch.config as tcfg
from _torch_port_setup import (TOL, jax_variable_template, make_cfgs,
                               port_model, se3, shared_weights, to_np)
from far3d_tpu.models.detector import Far3D as JaxFar3D
from far3d_tpu.models.detector import decode_detections as jax_decode
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.utils.torch_convert import (convert_state_dict,
                                           reference_key_shapes)
from far3d_tpu_torch.entry import run_frame
from far3d_tpu_torch.models.detector import decode_detections
from far3d_tpu_torch.models.farhead import init_state as torch_init_state
from far3d_tpu_torch.utils.convert import (from_jax_variables,
                                           random_reference_state_dict)
from far3d_tpu_torch.utils.synthetic import ring_cameras

GOLDEN = pathlib.Path(__file__).parent / 'data' / 'golden_tiny.npz'


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(cfg):
    """Two frames of one stream: a fresh start, then a moved ego pose."""
    rng = np.random.default_rng(7)
    n = cfg.data.num_cams
    h, w = cfg.data.input_hw
    intr, extr = ring_cameras(n, h, w)
    l2i = np.einsum('nij,njk->nik', intr, extr).astype(np.float32)[None]
    frames = []
    for prev, ts, ego in ((0.0, 10.0, np.eye(4, dtype=np.float32)),
                          (1.0, 10.5, se3(0.03, [1.5, 0.2, 0.0]))):
        frames.append(dict(
            images=(rng.standard_normal((1, n, h, w, 3)) * 0.5
                    ).astype(np.float32),
            lidar2img=l2i, intrinsics=intr[None], extrinsics=extr[None],
            prev_exists=np.float32([prev]), timestamp=np.float32([ts]),
            ego_pose=ego[None],
            ego_pose_inv=np.linalg.inv(ego).astype(np.float32)[None]))
    return frames


def test_full_model_two_frames_against_jax():
    jax_cfg, port_cfg = make_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg)
    model = port_model(port_cfg, sd)
    japply = jax.jit(JaxFar3D(jax_cfg).apply)
    jstate = jax_init_state(1, jax_cfg.head)
    tstate = torch_init_state(1, port_cfg.head, 'cpu')
    nq = jax_cfg.head.num_query
    s = jax_cfg.head.multi_depth.topk
    k2d = jax_cfg.roi2d.num_proposals_2d * s
    for frame, f in enumerate(_frames(jax_cfg)):
        want = japply(variables, state=jstate,
                      **{k: jnp.asarray(v) for k, v in f.items()})
        jstate = want['state']
        with torch.no_grad():
            got = model(state=tstate, **{k: _t(v) for k, v in f.items()})
        tstate = got['state']

        # 2D proposal queries: top-K orders tied (zero-score, invalid)
        # proposals differently, so match the valid slots by key
        def slots(out):
            p = out['proposals']
            valid = to_np(out['query_valid'][0])[nq:nq + k2d]
            cam, flat = to_np(p['cam_idx'][0]), to_np(p['flat_idx'][0])
            return {(int(cam[i // s]), int(flat[i // s]), i % s): nq + i
                    for i in np.flatnonzero(valid)}

        mine, ref = slots(got), slots(want)
        assert 0 < len(ref) and set(mine) == set(ref), frame
        keys = sorted(ref)
        idx_t = np.r_[np.arange(nq), [mine[k] for k in keys],
                      np.arange(nq + k2d, nq + k2d + jax_cfg.head.num_propagated)]
        idx_j = np.r_[np.arange(nq), [ref[k] for k in keys],
                      np.arange(nq + k2d, nq + k2d + jax_cfg.head.num_propagated)]
        for name in ('all_cls_scores', 'all_bbox_preds'):
            np.testing.assert_allclose(
                to_np(got[name])[:, :, idx_t], np.asarray(want[name])[:, :, idx_j],
                err_msg=f'{name} frame {frame}', **TOL)
        for field in ('embedding', 'ref_points', 'timestamp', 'egopose',
                      'velo'):
            np.testing.assert_allclose(
                to_np(getattr(tstate, field)), np.asarray(getattr(jstate, field)),
                err_msg=f'state.{field} frame {frame}', **TOL)
        # detections come from valid queries only
        jd = jax_decode(want['all_cls_scores'][-1], want['all_bbox_preds'][-1],
                        want['query_valid'], jax_cfg)
        td = decode_detections(got['all_cls_scores'][-1],
                               got['all_bbox_preds'][-1], got['query_valid'],
                               port_cfg)
        for name in ('scores', 'boxes'):
            np.testing.assert_allclose(to_np(td[name]), np.asarray(jd[name]),
                                       err_msg=f'dets.{name} frame {frame}',
                                       **TOL)
        assert np.array_equal(to_np(td['labels']), np.asarray(jd['labels']))
        assert np.array_equal(to_np(td['valid']), np.asarray(jd['valid']))


def test_state_dict_matches_reference_key_shapes():
    jax_cfg, port_cfg = make_cfgs()
    want = reference_key_shapes(jax_cfg, jax_variable_template(jax_cfg))
    model = port_model(port_cfg, random_reference_state_dict(port_cfg, 0))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert 'img_backbone.stem.stem_1/conv.weight' in got


def test_from_jax_variables_inverts_convert_state_dict():
    jax_cfg, port_cfg = make_cfgs()
    sd = random_reference_state_dict(port_cfg, 3)
    converted, _ = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                      jax_cfg, jax_variable_template(jax_cfg))
    back = from_jax_variables(converted, port_cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def _golden_inputs(cfg):
    b, n = 1, cfg.data.num_cams
    h, w = cfg.data.input_hw
    imgs = jax.random.normal(jax.random.PRNGKey(0), (b, n, h, w, 3),
                             jnp.float32)
    intr = jnp.tile(jnp.eye(4)[None, None], (b, n, 1, 1))
    intr = intr.at[:, :, 0, 0].set(w / 2).at[:, :, 1, 1].set(w / 2)
    intr = intr.at[:, :, 0, 2].set(w / 2).at[:, :, 1, 2].set(h / 2)
    extr = jnp.tile(jnp.eye(4)[None, None], (b, n, 1, 1))
    return dict(
        images=imgs, lidar2img=jnp.einsum('bnij,bnjk->bnik', intr, extr),
        intrinsics=intr, extrinsics=extr, prev_exists=jnp.zeros((b,)),
        timestamp=jnp.zeros((b,)), ego_pose=jnp.tile(jnp.eye(4)[None], (b, 1, 1)),
        ego_pose_inv=jnp.tile(jnp.eye(4)[None], (b, 1, 1)))


def test_port_reproduces_jax_golden_outputs():
    """The JAX golden parameters (tests/test_golden.py: init with
    PRNGKey(1)), carried across by from_jax_variables, reproduce the recorded
    outputs of tests/data/golden_tiny.npz over two streaming frames."""
    recorded = dict(np.load(GOLDEN))
    jax_cfg, port_cfg = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    data = _golden_inputs(jax_cfg)
    variables = jax.jit(JaxFar3D(jax_cfg).init)(
        jax.random.PRNGKey(1), state=jax_init_state(1, jax_cfg.head), **data)
    model = port_model(port_cfg, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables), port_cfg))

    inputs = {k: _t(v) for k, v in data.items()}
    state = torch_init_state(1, port_cfg.head, 'cpu')
    with torch.no_grad():
        out1 = model(state=state, **inputs)
    inputs.update(prev_exists=torch.ones(1), timestamp=torch.ones(1))
    dets, state2 = run_frame(model, out1['state'], **inputs)
    with torch.no_grad():
        out2 = model(state=out1['state'], **inputs)

    for tag, out in (('f1', out1), ('f2', out2)):
        for name, key in (('all_cls_scores', 'cls'),
                          ('all_bbox_preds', 'bbox')):
            np.testing.assert_allclose(to_np(out[name]),
                                       recorded[f'{key}_{tag}'],
                                       err_msg=f'{key}_{tag}', **TOL)
    np.testing.assert_allclose(to_np(state2.embedding),
                               recorded['mem_embed_f2'], **TOL)
    np.testing.assert_allclose(to_np(dets['boxes']), recorded['det_boxes'],
                               **TOL)
    np.testing.assert_allclose(to_np(dets['scores']), recorded['det_scores'],
                               **TOL)
