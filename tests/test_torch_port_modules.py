"""Module parity of the PyTorch port (far3d_tpu_torch) with the JAX package,
on shared seeded weights, at tests/test_composed_parity.py's tolerance
(rtol 1e-3, atol 2e-3), in f32 on the CPU."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far3d_tpu.geometry as jgeo
import far3d_tpu.models.layers as jlayers
import far3d_tpu_torch.geometry as tgeo
import far3d_tpu_torch.models.layers as tlayers
from _torch_port_setup import (TOL, make_cfgs, nchw, port_model, se3,
                               shared_weights, to_np)
from far3d_tpu.models.decoder import DecoderLayer as JaxDecoderLayer
from far3d_tpu.models.decoder import DeformableAggregation as JaxDeformAgg
from far3d_tpu.models.detector import level_shapes
from far3d_tpu.models.farhead import FarHead as JaxFarHead
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.models.heads2d import YoloxHead2D as JaxYolox
from far3d_tpu.models.heads2d import select_proposals as jax_select
from far3d_tpu.models.vovnet import FPN as JaxFPN
from far3d_tpu.models.vovnet import VoVNet as JaxVoVNet
from far3d_tpu_torch.models.farhead import init_state as torch_init_state
from far3d_tpu_torch.models.heads2d import select_proposals as torch_select
from far3d_tpu_torch.utils.synthetic import ring_cameras


@pytest.fixture(scope='module')
def setup():
    jax_cfg, port_cfg = make_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg)
    return jax_cfg, port_cfg, variables, port_model(port_cfg, sd)


def _close(got, want, tol=TOL, msg=''):
    np.testing.assert_allclose(to_np(got), np.asarray(want), err_msg=msg, **tol)


# ---------------------------------------------------------------- geometry

def _geometry_cases():
    rng = np.random.RandomState(0)
    u = rng.uniform(-0.2, 1.2, (4, 6, 3)).astype(np.float32)
    code = rng.randn(4, 10).astype(np.float32)
    mats = np.stack([se3(0.3 * i, rng.randn(3)) for i in range(4)])
    pts = rng.randn(4, 5, 3).astype(np.float32) * 10
    intr, extr = ring_cameras(4, 64, 96)
    l2i = np.einsum('nij,njk->nik', intr, extr).astype(np.float32)
    uv = rng.uniform(0, 96, (4, 2)).astype(np.float32)
    depth = rng.uniform(1, 50, (4, 1)).astype(np.float32)
    bins = rng.randint(0, 50, (4, 6))
    pcr = (-10.0, -10.0, 0.5, 10.0, 10.0, 12.0)
    return {
        'inverse_sigmoid': (lambda m: m.inverse_sigmoid, (u,)),
        'lid_bin_to_depth': (lambda m: lambda i: m.lid_bin_to_depth(
            i, 0.1, 110.0, 50), (bins,)),
        'denormalize_bbox': (lambda m: m.denormalize_bbox, (code,)),
        'pos2posemb3d': (lambda m: m.pos2posemb3d, (u,)),
        'pos2posemb1d': (lambda m: m.pos2posemb1d, (u[..., :1],)),
        'nerf_positional_encoding': (lambda m: m.nerf_positional_encoding,
                                     (u,)),
        'transform_points': (lambda m: m.transform_points, (pts, mats)),
        'unproject_to_lidar': (lambda m: m.unproject_to_lidar,
                               (uv, depth, np.linalg.inv(l2i))),
        'project_to_image': (lambda m: m.project_to_image, (pts[:, 0], l2i)),
        'normalize_to_pc_range': (lambda m: lambda p: m.normalize_to_pc_range(
            p, pcr), (pts,)),
        'denormalize_from_pc_range': (
            lambda m: lambda p: m.denormalize_from_pc_range(p, pcr), (u,)),
    }


GEOMETRY = _geometry_cases()


@pytest.mark.parametrize('name', sorted(GEOMETRY))
def test_geometry(name):
    fn, args = GEOMETRY[name]
    want = fn(jgeo)(*[jnp.asarray(a) for a in args])
    got = fn(tgeo)(*[torch.from_numpy(np.asarray(a)) for a in args])
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, dict(rtol=1e-5, atol=1e-5))
    else:
        _close(got, want, dict(rtol=1e-5, atol=1e-5))


# ------------------------------------------------------------------ layers

def _lin(m):
    return {'kernel': to_np(m.weight).T, 'bias': to_np(m.bias)}


def _conv(m):
    p = {'kernel': np.transpose(to_np(m.weight), (2, 3, 1, 0))}
    if m.bias is not None:
        p['bias'] = to_np(m.bias)
    return p


def _bn(m):
    return ({'scale': to_np(m.weight), 'bias': to_np(m.bias)},
            {'mean': to_np(m.running_mean), 'var': to_np(m.running_var)})


def _randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            if 'running_var' in name:
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
    return module


def _layer_cases():
    rng = np.random.RandomState(1)
    img = rng.randn(2, 10, 12, 16).astype(np.float32)      # NHWC
    vec = rng.randn(2, 7, 32).astype(np.float32)
    cond = rng.randn(2, 7, 14).astype(np.float32)

    def frozen_bn():
        m = _randomize(tlayers.FrozenBatchNorm(16), 0)
        p, s = _bn(m)
        return (jlayers.FrozenBatchNorm(16), {'params': p, 'stats': s},
                (img,), m, (nchw(img),), True)

    def conv_bn_relu():
        m = _randomize(tlayers.ConvBNReLU('blk', 16, 24, 3, stride=2), 1)
        conv, bn = m[0], m[1]
        p, s = _bn(bn)
        return (jlayers.ConvBNReLU(24, 3, stride=2),
                {'params': {'conv': _conv(conv), 'bn': p}, 'stats': {'bn': s}},
                (img,), m, (nchw(img),), True)

    def group_norm_conv():
        m = _randomize(tlayers.GroupNormConv(16, 64), 2)
        return (jlayers.GroupNormConv(64),
                {'params': {'conv': _conv(m[0]),
                            'gn': {'scale': to_np(m[1].weight),
                                   'bias': to_np(m[1].bias)}}},
                (img,), m, (nchw(img),), True)

    def mln():
        m = _randomize(tlayers.MLN(14, 32), 3)
        return (jlayers.MLN(32),
                {'params': {'reduce': _lin(m.reduce[0]), 'gamma': _lin(m.gamma),
                            'beta': _lin(m.beta)}},
                (vec, cond), m, (torch.from_numpy(vec), torch.from_numpy(cond)),
                False)

    def se_layer_linear():
        m = _randomize(tlayers.SELayerLinear(32), 4)
        return (jlayers.SELayerLinear(32),
                {'params': {'reduce': _lin(m.reduce), 'expand': _lin(m.expand)}},
                (vec, vec[::-1].copy()), m,
                (torch.from_numpy(vec), torch.from_numpy(vec[::-1].copy())),
                False)

    def mlp():
        m = _randomize(tlayers.MLP((48, 16), in_dim=32), 5)
        return (jlayers.MLP((48, 16)),
                {'params': {'dense0': _lin(m[0]), 'dense1': _lin(m[2])}},
                (vec,), m, (torch.from_numpy(vec),), False)

    def ffn():
        m = _randomize(tlayers.FFN(32, 64), 6)
        return (jlayers.FFN(32, 64),
                {'params': {'fc1': _lin(m.layers[0][0]),
                            'fc2': _lin(m.layers[1])}},
                (vec,), m, (torch.from_numpy(vec),), False)

    return {f.__name__: f for f in (frozen_bn, conv_bn_relu, group_norm_conv,
                                    mln, se_layer_linear, mlp, ffn)}


LAYERS = _layer_cases()


@pytest.mark.parametrize('name', sorted(LAYERS))
def test_layer(name):
    jmod, jvars, jargs, tmod, targs, is_image = LAYERS[name]()
    want = jmod.apply(jax.tree_util.tree_map(jnp.asarray, jvars),
                      *[jnp.asarray(a) for a in jargs])
    with torch.no_grad():
        got = tmod(*targs)
    if is_image:
        got = got.permute(0, 2, 3, 1)
    _close(got, want)


# ------------------------------------------------- backbone, FPN, 2D head

def _images(cfg, seed=10):
    rng = np.random.default_rng(seed)
    h, w = cfg.data.input_hw
    return (rng.standard_normal((cfg.data.num_cams, h, w, 3)) * 0.5
            ).astype(np.float32)


def _feat_pyramid(cfg, seed=10):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.data.num_cams, h, w, cfg.neck.out_channels)
                                ).astype(np.float32)
            for h, w in level_shapes(cfg)]


def test_vovnet_fpn(setup):
    jax_cfg, _, variables, model = setup
    x = _images(jax_cfg)
    stages = JaxVoVNet(jax_cfg.backbone).apply(
        {'params': variables['params']['backbone'],
         'stats': variables['stats']['backbone']}, jnp.asarray(x))
    outs = JaxFPN(jax_cfg.neck).apply(
        {'params': variables['params']['neck']}, stages)
    with torch.no_grad():
        t_stages = model.img_backbone(nchw(x))
        t_outs = model.img_neck(t_stages)
    for i, (g, w) in enumerate(zip(t_stages, stages)):
        _close(g.permute(0, 2, 3, 1), w, msg=f'stage {i}')
    for i, (g, w) in enumerate(zip(t_outs, outs)):
        _close(g.permute(0, 2, 3, 1), w, msg=f'fpn level {i}')


@pytest.fixture(scope='module')
def yolox(setup):
    """(JAX head outputs, port head outputs) on one random feature pyramid."""
    jax_cfg, _, variables, model = setup
    feats = _feat_pyramid(jax_cfg)
    want = JaxYolox(jax_cfg.roi2d, jax_cfg.depthnet).apply(
        {'params': variables['params']['roi_head'],
         'batch_stats': variables['batch_stats']['roi_head']},
        [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = model.img_roi_head([nchw(f) for f in feats])
    return want, got


def test_yolox_head(yolox):
    want, got = yolox
    for key in ('cls_scores', 'bbox_preds', 'objectnesses',
                'centers2d_offsets'):
        for lvl, (g, w) in enumerate(zip(got[key], want[key])):
            _close(g, w, msg=f'{key} level {lvl}')
    _close(got['depth_logit'], want['depth_logit'])


def test_select_proposals_by_key(setup, yolox):
    """Same valid proposal set, matched by (cam, flat_idx): top-K orders
    ties differently in the two frameworks."""
    jax_cfg = setup[0]
    want_maps, got_maps = yolox
    args = (1, jax_cfg.data.num_cams, jax_cfg.roi2d.strides,
            jax_cfg.roi2d.num_proposals_2d, jax_cfg.roi2d.threshold_score)
    want = jax_select(want_maps, *args)
    got = torch_select(got_maps, *args)

    def by_key(p):
        valid = to_np(p['valid'][0])
        return {(int(to_np(p['cam_idx'][0, k])), int(to_np(p['flat_idx'][0, k]))):
                (to_np(p['boxes'][0, k]), to_np(p['scores'][0, k]))
                for k in np.flatnonzero(valid)}

    mine, ref = by_key(got), by_key(want)
    assert 0 < len(ref) < jax_cfg.roi2d.num_proposals_2d
    assert set(mine) == set(ref)
    for key, (box, score) in ref.items():
        _close(mine[key][0], box, msg=f'box {key}')
        _close(mine[key][1], score, msg=f'score {key}')


# ----------------------------------------------------------------- decoder

def _decoder_inputs(cfg, seed=4, q=30, mem=12):
    rng = np.random.default_rng(seed)
    n = cfg.data.num_cams
    h, w = cfg.data.input_hw
    c = cfg.head.embed_dims
    lt = sum(hh * ww for hh, ww in level_shapes(cfg))
    intr, extr = ring_cameras(n, h, w)
    return dict(
        query=rng.standard_normal((1, q, c)).astype(np.float32),
        query_pos=rng.standard_normal((1, q, c)).astype(np.float32),
        temp_memory=rng.standard_normal((1, mem, c)).astype(np.float32),
        temp_pos=rng.standard_normal((1, mem, c)).astype(np.float32),
        feat=rng.standard_normal((n, lt, c)).astype(np.float32),
        refp=rng.uniform(0.1, 0.9, (1, q, 3)).astype(np.float32),
        l2i=np.einsum('nij,njk->nik', intr, extr).astype(np.float32)[None],
        mask=rng.random((q, q + mem)) < 0.15)


@pytest.mark.parametrize('route', ['xla', 'pallas_interpret'])
def test_deformable_aggregation(setup, route):
    """The module that holds the kernel. With the JAX side on its Pallas
    kernel (interpret mode), the tolerance is the kernel's bf16 staging
    (msda_pallas.py:182,202-204) carried through output_proj."""
    jax_cfg, _, variables, model = setup
    d = _decoder_inputs(jax_cfg)
    shapes = level_shapes(jax_cfg)
    deform = dataclasses.replace(jax_cfg.deform,
                                 use_pallas=route == 'pallas_interpret')
    jmod = JaxDeformAgg(deform, shapes, jax_cfg.data.input_hw, jax_cfg.pc_range)
    jvars = {'params': variables['params']['pts_head']['decoder']['layer0'][
        'cross_attn']}
    args = [jnp.asarray(d[k]) for k in ('query', 'query_pos', 'feat', 'refp',
                                        'l2i')]
    if route == 'xla':
        want, tol = jmod.apply(jvars, *args), TOL
    else:
        from jax.experimental import pallas as pl
        from far3d_tpu.ops import msda_pallas as mp
        orig_call = pl.pallas_call

        def interp_call(*a, **k):
            k['interpret'] = True
            return orig_call(*a, **k)

        def no_fallback(*a, **k):
            raise AssertionError('the JAX side left its Pallas kernel')

        mp._clear_kernel_caches()
        with mock.patch.object(mp.pl, 'pallas_call', interp_call), \
                mock.patch('far3d_tpu.ops.msda.msda_xla', no_fallback):
            want = jmod.apply(jvars, *args)
        mp._clear_kernel_caches()
        tol = dict(rtol=2e-2, atol=2e-2)
    layer = model.pts_bbox_head.transformer['decoder'].layers[0]
    with torch.no_grad():
        got = layer.attentions[1](*[torch.from_numpy(d[k]) for k in (
            'query', 'query_pos', 'feat', 'refp', 'l2i')])
    _close(got, want, tol)


def test_decoder_layer(setup):
    jax_cfg, _, variables, model = setup
    d = _decoder_inputs(jax_cfg)
    jmod = JaxDecoderLayer(jax_cfg.decoder, jax_cfg.deform,
                           level_shapes(jax_cfg), jax_cfg.data.input_hw,
                           jax_cfg.pc_range)
    keys = ('query', 'query_pos', 'feat', 'temp_memory', 'temp_pos', 'refp',
            'l2i', 'mask')
    want = jmod.apply(
        {'params': variables['params']['pts_head']['decoder']['layer0']},
        *[jnp.asarray(d[k]) for k in keys])
    layer = model.pts_bbox_head.transformer['decoder'].layers[0]
    with torch.no_grad():
        got = layer(*[torch.from_numpy(d[k]) for k in keys])
    _close(got, want)


# ----------------------------------------------------------------- FarHead

def _frame_inputs(cfg, rng, n_valid=20):
    n = cfg.data.num_cams
    h, w = cfg.data.input_hw
    h8, w8 = h // cfg.depthnet.stride, w // cfg.depthnet.stride
    lt = sum(hh * ww for hh, ww in level_shapes(cfg))
    k = cfg.roi2d.num_proposals_2d
    logits = rng.standard_normal((n, h8 * w8, cfg.depthnet.num_depth_bins + 1))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = np.arange(k) < n_valid
    scores = rng.uniform(0.15, 0.9, (k, 1)).astype(np.float32)
    scores[~valid] = 0.01
    return dict(
        feat=rng.standard_normal((n, lt, cfg.head.embed_dims)).astype(np.float32),
        depth_probs=probs.astype(np.float32)[None],
        proposals=dict(
            boxes=np.stack([rng.uniform(2, w - 2, k), rng.uniform(2, h - 2, k),
                            rng.uniform(4, 40, k), rng.uniform(4, 40, k)],
                           -1).astype(np.float32)[None],
            scores=scores[None],
            cam_idx=rng.integers(0, n, k).astype(np.int32)[None],
            flat_idx=rng.choice(lt, size=k, replace=False).astype(np.int32)[None],
            valid=valid[None]))


def test_farhead_two_frames(setup):
    """Two streaming frames with the memory carried; the proposals are the
    same inputs on both sides, so queries line up one to one."""
    jax_cfg, _, variables, model = setup
    rng = np.random.default_rng(5)
    n = jax_cfg.data.num_cams
    h, w = jax_cfg.data.input_hw
    intr, extr = ring_cameras(n, h, w)
    l2i = np.einsum('nij,njk->nik', intr, extr).astype(np.float32)[None]
    jhead = JaxFarHead(jax_cfg.head, jax_cfg.decoder, jax_cfg.deform,
                       jax_cfg.depthnet, jax_cfg.pc_range, level_shapes(jax_cfg),
                       (h, w), jax_cfg.roi2d.threshold_score)
    jvars = {'params': variables['params']['pts_head']}
    japply = jax.jit(jhead.apply)
    jstate = jax_init_state(1, jax_cfg.head)
    tstate = torch_init_state(1, setup[1].head, 'cpu')
    ego1 = se3(0.03, [1.5, 0.2, 0.0])
    for frame, (prev, ts, ego) in enumerate(
            [(0.0, 100.0, np.eye(4, dtype=np.float32)), (1.0, 100.5, ego1)]):
        f = _frame_inputs(jax_cfg, rng)
        common = dict(lidar2img=l2i, intrinsics=intr[None],
                      extrinsics=extr[None], prev_exists=np.float32([prev]),
                      timestamp=np.float32([ts]), ego_pose=ego[None],
                      ego_pose_inv=np.linalg.inv(ego).astype(np.float32)[None],
                      depth_probs=f['depth_probs'])
        want = japply(
            jvars, feat_flatten=jnp.asarray(f['feat']), state=jstate,
            proposals={k: jnp.asarray(v) for k, v in f['proposals'].items()},
            **{k: jnp.asarray(v) for k, v in common.items()})
        jstate = want['state']
        with torch.no_grad():
            got = model.pts_bbox_head(
                feat_flatten=torch.from_numpy(f['feat']), state=tstate,
                proposals={k: torch.from_numpy(v).long() if v.dtype == np.int32
                           else torch.from_numpy(v)
                           for k, v in f['proposals'].items()},
                **{k: torch.from_numpy(v) for k, v in common.items()})
        tstate = got['state']
        for key in ('all_cls_scores', 'all_bbox_preds'):
            _close(got[key], want[key], msg=f'{key} frame {frame}')
        assert np.array_equal(to_np(got['query_valid']),
                              np.asarray(want['query_valid']))
        for field in ('embedding', 'ref_points', 'timestamp', 'egopose',
                      'velo'):
            _close(getattr(tstate, field), getattr(jstate, field),
                   msg=f'state.{field} frame {frame}')


def test_query2d_log_odds_of_saturated_bf16_scores_are_finite(setup):
    """With bf16 heads a confident 2D proposal's score rounds to 1.0, and
    1 - 1e-5 rounds to 1.0 too, so a clip in the scores' dtype leaves an
    infinite log-odds and a NaN context: the full-width closed loop met it
    at its second step. The port takes the log-odds in f32: a score of 1.0
    reads as the clip's 1 - 1e-5."""
    from far3d_tpu_torch.models.farhead import build_query2d_proposals
    _, cfg, _, _ = setup
    n = cfg.data.num_cams
    h, w = cfg.data.input_hw
    d = cfg.depthnet
    h8, w8 = h // d.stride, w // d.stride
    k = 4
    proposals = dict(
        boxes=torch.tensor([[[20.0, 16.0, 8.0, 8.0]] * k]),
        scores=torch.tensor([[[1.0], [0.999], [0.5], [0.2]]],
                            dtype=torch.bfloat16),
        cam_idx=torch.zeros(1, k, dtype=torch.long),
        flat_idx=torch.arange(k)[None],
        valid=torch.ones(1, k, dtype=torch.bool))
    depth_probs = torch.full((1, n, h8 * w8, d.num_depth_bins + 1),
                             1.0 / (d.num_depth_bins + 1))
    feat = torch.zeros(1, n, 40, 8, dtype=torch.bfloat16)
    intr, extr = ring_cameras(n, h, w)
    l2i = torch.from_numpy(np.einsum('nij,njk->nik', intr, extr)[None]
                           .astype(np.float32))
    _, ctx, _ = build_query2d_proposals(
        proposals, depth_probs, feat, l2i, (h, w), d, cfg.head.multi_depth,
        cfg.pc_range, cfg.roi2d.threshold_score)
    assert torch.isfinite(ctx.float()).all()
    s = max(cfg.head.multi_depth.topk, 1)
    lo = ctx[0, ::s, -1].float()
    thr = cfg.roi2d.threshold_score
    want = np.log(np.float32(1 - 1e-5) / np.float32(1e-5)) - np.log(
        thr / (1 - thr))
    np.testing.assert_allclose(lo[0].item(), want, rtol=1e-2)
