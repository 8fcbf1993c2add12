"""The modules of the port's training slice against the JAX package, in f32
on the CPU at small sizes: the plain MSDA backward, the gradients of the
module that holds the MSDA kernel, grid mask and DN fed the JAX draws,
SimOTA and the 2D loss, the 3D set loss with its matching, the optimizer and
schedule, the flax-semantics BatchNorm and dropout. The whole step is held
to ``make_train_step`` in tests/test_torch_port_train_step.py. Matching runs
the auction on both sides (the port's ``auction_match`` is the JAX
package's, assignment for assignment: tests/test_torch_port_matching.py).
Tolerances: 1e-4 where both sides run the same f32 algorithm on one op, the
composed parity tolerance TOL (rtol 1e-3 / atol 2e-3) through modules and
losses, exact for integer draws, masks and assignments.
"""

import dataclasses
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import far3d_tpu_torch.train.losses3d as tl3d
from _msda_cases import CASES, _case
from _torch_port_setup import TOL, make_cfgs, shared_weights, to_np
from far3d_tpu.models.decoder import DeformableAggregation as JaxDeformAgg
from far3d_tpu.models.detector import level_shapes
from far3d_tpu.ops.grid_mask import grid_mask as jax_grid_mask
from far3d_tpu.ops.msda import msda_xla
from far3d_tpu.train import dn as jax_dn
from far3d_tpu.train import losses3d as jax_losses3d
from far3d_tpu.train.losses2d import simota_assign as jax_simota
from far3d_tpu.train.losses2d import yolox_loss as jax_yolox_loss
from far3d_tpu.train.optim import lr_schedule as jax_lr_schedule
from far3d_tpu.train.optim import make_optimizer as jax_make_optimizer
from far3d_tpu.utils.synthetic import synthetic_batch as jax_synthetic_batch
from far3d_tpu_torch.models.heads2d import decode_boxes, flatten_levels
from far3d_tpu_torch.models.heads2d import make_priors
from far3d_tpu_torch.models.layers import BatchNorm, dropout
from far3d_tpu_torch.ops import grid_mask
from far3d_tpu_torch.ops.msda import (dval_segments, hit_records,
                                      msda_backward_reference)
from far3d_tpu_torch.train import dn as tdn
from far3d_tpu_torch.train import optim as toptim
from far3d_tpu_torch.train.losses2d import simota_assign, yolox_loss
from far3d_tpu_torch.utils.synthetic import ring_cameras


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope='module')
def cfgs():
    return make_cfgs()


# ------------------------------------------------------------- MSDA backward

def _cotangent(value, loc, seed=7):
    return np.random.RandomState(seed).randn(
        value.shape[0], loc.shape[1], value.shape[2]).astype(np.float32)


@pytest.mark.parametrize('case', sorted(CASES))
def test_msda_backward_reference_matches_msda_xla_vjp(case):
    """Same f32 algorithm on both sides: 1e-4."""
    value, shapes, loc, weights = CASES[case]()
    g_out = _cotangent(value, loc)
    _, vjp = jax.vjp(lambda v, l, w: msda_xla(v, shapes, l, w),
                     *map(jnp.asarray, (value, loc, weights)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(g_out))]
    got = msda_backward_reference(*_t(value), shapes, *_t(loc, weights, g_out))
    for name, g, w in zip(('value', 'loc', 'weights'), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f'd_{name}')
    if case == 'outside':
        assert not any(g.any() for g in got[:2])


def _segment_sum(value, shapes, loc, weights, g_out):
    """d_value from the bucketing the CUDA value gradient runs: each sorted
    record's contribution bw * w[b, q, g, l, p] * g_out[b, q], added into
    its value row in the sorted order. Also checks the order itself:
    segment ids non-decreasing, one segment's records by ascending slot,
    each segment's records between its starts, the sentinel keys after
    every hit."""
    b, rows, c = value.shape
    _, q, p, _ = loc.shape
    g, n_lvl = weights.shape[2], weights.shape[3]
    keys, bw = hit_records(loc, shapes)
    assert keys.dtype == (torch.int16 if rows <= 32767 else torch.int32)
    sorted_keys, order, starts = dval_segments(keys, b, rows)
    n = int(starts[-1])
    assert n == int((bw != 0).sum()) == int((keys < rows).sum())
    assert (sorted_keys[n:] == rows).all()
    slot = order[:n]
    cam = slot // (q * n_lvl * p * 4)
    seg = sorted_keys[:n].long() * b + cam
    assert ((seg[1:] > seg[:-1])
            | ((seg[1:] == seg[:-1]) & (slot[1:] > slot[:-1]))).all()
    assert torch.equal(seg, torch.repeat_interleave(
        torch.arange(b * rows), (starts[1:] - starts[:-1]).long()))
    point = slot // 4                       # ((b*Q + q)*L + l)*P + p
    bq, lvl, pt = point // (n_lvl * p), (point // p) % n_lvl, point % p
    coef = bw[slot, None] * weights.reshape(b * q, g, n_lvl, p)[bq, :, lvl, pt]
    contrib = (coef[:, :, None] * g_out.reshape(b * q, g, c // g)[bq]
               ).reshape(n, c)
    row = cam * rows + sorted_keys[:n].long()
    return torch.zeros(b * rows, c).index_add_(0, row, contrib).reshape(
        b, rows, c)


@pytest.mark.parametrize('case', sorted(CASES))
def test_dval_segments_sum_to_msda_xla_vjp(case):
    """The ordering the CUDA value gradient sums in (``hit_records`` as its
    records kernel writes the keys, then ``dval_segments``: the stable sort
    and the plain version of its starts kernel), summed segment by segment,
    against the value gradient of ``jax.vjp(msda_xla)``: 1e-4 in f32, as
    the plain backward above."""
    value, shapes, loc, weights = CASES[case]()
    g_out = _cotangent(value, loc)
    _, vjp = jax.vjp(lambda v: msda_xla(v, shapes, jnp.asarray(loc),
                                        jnp.asarray(weights)),
                     jnp.asarray(value))
    want = np.asarray(vjp(jnp.asarray(g_out))[0])
    got = _segment_sum(*_t(value), shapes, *_t(loc, weights, g_out))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if case == 'outside':
        assert not got.any()


def test_msda_backward_reference_matches_pallas_custom_vjp():
    """The Pallas backward (interpret mode) rounds d_acc and the corner
    weights to bf16 (msda_pallas.py:282,286,365-368): rtol 2e-2 and atol
    2e-2 plus 2e-3 of the tensor's largest entry (d_loc spans ~+-25), the
    tolerance of tests/test_msda.py:167-168."""
    from jax.experimental import pallas as pl
    from far3d_tpu.ops import msda_pallas as mp
    value, shapes, loc, weights = _case(4, -0.2, 1.2, shapes=((6, 8), (3, 4)))
    g_out = _cotangent(value, loc)
    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k['interpret'] = True
        return orig_call(*a, **k)

    mp._clear_kernel_caches()
    with mock.patch.object(mp.pl, 'pallas_call', interp_call):
        _, vjp = jax.vjp(lambda v, l, w: mp.msda_pallas(v, tuple(shapes), l, w),
                         *map(jnp.asarray, (value, loc, weights)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(g_out))]
    mp._clear_kernel_caches()
    got = msda_backward_reference(*_t(value), shapes, *_t(loc, weights, g_out))
    for name, g, w in zip(('value', 'loc', 'weights'), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-2,
                                   atol=2e-2 + 2e-3 * np.abs(w).max(),
                                   err_msg=f'd_{name}')


def test_msda_backward_reference_bf16_value():
    """A bf16 value gives a bf16 d_value, rounded once from the f32 sum."""
    value, shapes, loc, weights = CASES['mixed']()
    g_out = _cotangent(value, loc)
    v16 = torch.from_numpy(value).to(torch.bfloat16)
    d16 = msda_backward_reference(v16, shapes, *_t(loc, weights),
                                  torch.from_numpy(g_out).to(torch.bfloat16))
    d32 = msda_backward_reference(v16.float(), shapes, *_t(loc, weights),
                                  torch.from_numpy(g_out).to(torch.bfloat16))
    assert d16[0].dtype == torch.bfloat16
    assert torch.equal(d16[0], d32[0].to(torch.bfloat16))


# ------------------------------------- the module that holds the MSDA kernel

def test_deformable_aggregation_gradients(cfgs):
    """Parameter and input gradients of DeformableAggregation against
    jax.grad of the same module (f32, XLA MSDA on the JAX side): TOL."""
    jax_cfg, port_cfg = cfgs
    variables, sd = shared_weights(jax_cfg, port_cfg)
    from _torch_port_setup import port_model
    layer = port_model(port_cfg, sd).pts_bbox_head.transformer['decoder'] \
        .layers[0].attentions[1]
    rng = np.random.default_rng(4)
    n = jax_cfg.data.num_cams
    h, w = jax_cfg.data.input_hw
    c = jax_cfg.head.embed_dims
    q = 30
    lt = sum(hh * ww for hh, ww in level_shapes(jax_cfg))
    intr, extr = ring_cameras(n, h, w)
    inputs = dict(
        query=rng.standard_normal((1, q, c)).astype(np.float32),
        query_pos=rng.standard_normal((1, q, c)).astype(np.float32),
        feat=rng.standard_normal((n, lt, c)).astype(np.float32),
        refp=rng.uniform(0.1, 0.9, (1, q, 3)).astype(np.float32),
        l2i=np.einsum('nij,njk->nik', intr, extr).astype(np.float32)[None])
    ct = rng.standard_normal((1, q, c)).astype(np.float32)
    jmod = JaxDeformAgg(jax_cfg.deform, level_shapes(jax_cfg),
                        jax_cfg.data.input_hw, jax_cfg.pc_range)
    jparams = variables['params']['pts_head']['decoder']['layer0']['cross_attn']
    names = ('query', 'query_pos', 'feat', 'refp')

    def loss(params, *xs):
        out = jmod.apply({'params': params}, *xs, jnp.asarray(inputs['l2i']))
        return jnp.sum(out * ct)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jparams, *[jnp.asarray(inputs[k]) for k in names])
    xs = [torch.from_numpy(inputs[k]).requires_grad_() for k in names]
    out = layer(*xs, torch.from_numpy(inputs['l2i']))
    (out * torch.from_numpy(ct)).sum().backward()

    for name, x, want in zip(names, xs, grads[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   err_msg=f'd_{name}', **TOL)
    jp = grads[0]
    pairs = {'learnable_fc': layer.learnable_fc, 'weights_fc': layer.weights_fc,
             'output_proj': layer.output_proj,
             'cam_embed0': layer.cam_embed[0], 'cam_embed1': layer.cam_embed[2]}
    for jname, mod in pairs.items():
        np.testing.assert_allclose(mod.weight.grad.numpy().T,
                                   np.asarray(jp[jname]['kernel']),
                                   err_msg=jname, **TOL)
        np.testing.assert_allclose(mod.bias.grad.numpy(),
                                   np.asarray(jp[jname]['bias']),
                                   err_msg=jname, **TOL)
    ln = layer.cam_embed[4]
    np.testing.assert_allclose(ln.weight.grad.numpy(),
                               np.asarray(jp['cam_embed_ln']['scale']), **TOL)
    np.testing.assert_allclose(ln.bias.grad.numpy(),
                               np.asarray(jp['cam_embed_ln']['bias']), **TOL)


# --------------------------------------------------------------- grid mask

def _jax_grid_draws(key, h, prob):
    k_apply, k_d, k_sh, k_sw = jax.random.split(key, 4)
    d = int(jax.random.randint(k_d, (), 2, h))
    return dict(apply=bool(jax.random.uniform(k_apply) < prob), d=d,
                st_h=int(jax.random.randint(k_sh, (), 0, d)),
                st_w=int(jax.random.randint(k_sw, (), 0, d)))


@pytest.mark.parametrize('seed', [0, 9, 21])
def test_grid_mask_with_jax_draws(seed):
    """grid_mask.py:16-34 fed the draws of its own keys: exact."""
    key = jax.random.PRNGKey(seed)
    images = np.random.RandomState(seed).randn(1, 2, 40, 56, 3).astype(
        np.float32)
    want = np.asarray(jax_grid_mask(key, jnp.asarray(images), 0.7))
    draws = _jax_grid_draws(key, 40, 0.7)
    got = grid_mask.apply(torch.from_numpy(images), **draws).numpy()
    np.testing.assert_array_equal(got, want)
    assert draws['apply'] == (not np.array_equal(want, images))


def test_grid_mask_draws_in_range():
    gen = torch.Generator().manual_seed(0)
    draws = [grid_mask.draw(40, 0.7, gen) for _ in range(400)]
    assert all(2 <= d['d'] < 40 and 0 <= d['st_h'] < d['d']
               and 0 <= d['st_w'] < d['d'] for d in draws)
    assert 0.6 < np.mean([d['apply'] for d in draws]) < 0.8


# ---------------------------------------------------------------------- DN

def _jax_dn_draws(key, b, c):
    kp, kps, kn, kns = jax.random.split(key, 4)
    shape_p = (b, c.dn_groups, c.dn_max_gt, 3)
    shape_n = (b, c.dn_groups, c.num_smp_per_gt - 1, c.dn_max_gt, 3)

    def sign(k, shape):
        return jax.random.randint(k, shape, 0, 2).astype(jnp.float32) * 2 - 1

    return {k: torch.from_numpy(np.array(v)) for k, v in dict(
        rand_p=jax.random.uniform(kp, shape_p), sign_p=sign(kps, shape_p),
        rand_n=jax.random.uniform(kn, shape_n), sign_n=sign(kns, shape_n)
    ).items()}


@pytest.fixture(scope='module')
def dn_pair(cfgs):
    """JAX build_dn_queries and the port's build_dn on two batch lanes of
    synthetic GT, fed the JAX draws of one key."""
    jax_cfg, port_cfg = cfgs
    jb = jax_synthetic_batch(jax_cfg, batch=2, seed=5)
    key = jax.random.PRNGKey(2)
    want = jax_dn.build_dn_queries(key, jnp.asarray(jb.gt_boxes),
                                   jnp.asarray(jb.gt_labels),
                                   jnp.asarray(jb.gt_mask),
                                   jax_cfg.head, jax_cfg.pc_range)
    got = tdn.build_dn(_jax_dn_draws(key, 2, jax_cfg.head),
                       *_t(jb.gt_boxes, jb.gt_labels, jb.gt_mask),
                       port_cfg.head, port_cfg.pc_range)
    return want, got, jb


@pytest.mark.parametrize('field', ['ref_points', 'valid', 'labels',
                                   'bbox_targets', 'bbox_mask', 'num_tgt'])
def test_dn_with_jax_draws(dn_pair, field):
    want, got, _ = dn_pair
    w, g = np.asarray(want[field]), to_np(got[field])
    if w.dtype.kind in 'biu':
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_dn_draws_shapes_and_ranges(cfgs):
    c = cfgs[1].head
    noise = tdn.draw_noise(2, c, torch.Generator().manual_seed(0))
    assert noise['rand_p'].shape == (2, c.dn_groups, c.dn_max_gt, 3)
    assert noise['sign_n'].shape == (2, c.dn_groups, c.num_smp_per_gt - 1,
                                     c.dn_max_gt, 3)
    assert set(noise['sign_p'].unique().tolist()) == {-1.0, 1.0}
    assert 0 <= float(noise['rand_n'].min()) and float(noise['rand_n'].max()) < 1


# ------------------------------------------------------- SimOTA, 2D losses

@pytest.fixture(scope='module')
def yolox_pair(cfgs):
    """Random 2D head maps against the synthetic batch's 2D GT: the JAX and
    port SimOTA assignments, losses and map gradients."""
    jax_cfg, port_cfg = cfgs
    jb = jax_synthetic_batch(jax_cfg, batch=1, seed=6)
    n = jax_cfg.data.num_cams
    rc = jax_cfg.roi2d
    shapes = level_shapes(jax_cfg)
    rng = np.random.default_rng(8)

    def maps(ch, scale=1.0, shift=0.0):
        return [(rng.standard_normal((n, h, w, ch)) * scale + shift
                 ).astype(np.float32) for h, w in shapes]

    h8, w8 = shapes[0]
    outs = dict(cls_scores=maps(rc.num_classes, 1.0, -1.0),
                bbox_preds=maps(4, 0.3, 0.5), objectnesses=maps(1),
                centers2d_offsets=maps(2),
                depth_logit=rng.standard_normal(
                    (n, h8, w8, jax_cfg.depthnet.num_depth_bins + 1)
                ).astype(np.float32))
    gt = [np.asarray(getattr(jb, k)).reshape(n, *getattr(jb, k).shape[2:])
          for k in ('gt_boxes2d', 'gt_labels2d', 'gt_centers2d', 'gt_mask2d',
                    'gt_depth_bins', 'gt_depth_fg')]
    from far3d_tpu.models.heads2d import make_priors as jax_make_priors
    jpriors = jax_make_priors(shapes, jax_cfg.strides)

    def jloss(o):
        return jax_yolox_loss(o, jpriors, *map(jnp.asarray, gt), rc)

    jouts = jax.tree_util.tree_map(jnp.asarray, outs)
    want = {k: float(v) for k, v in jloss(jouts).items()}
    want_grad = jax.grad(lambda o: sum(jax.tree_util.tree_leaves(jloss(o))))(
        jouts)
    from far3d_tpu.models.heads2d import decode_boxes as jax_decode
    from far3d_tpu.models.heads2d import flatten_levels as jax_flatten
    jmatched = jax.vmap(lambda c, o, d, gb, gl, gm: jax_simota(
        c, o, jpriors, d, gb, gl, gm, rc))(
        jax_flatten(jouts['cls_scores']),
        jax_flatten(jouts['objectnesses'])[..., 0],
        jax_decode(jpriors, jax_flatten(jouts['bbox_preds'])),
        *map(jnp.asarray, (gt[0], gt[1], gt[3])))

    touts = {k: ([torch.from_numpy(m).requires_grad_() for m in v]
                 if isinstance(v, list) else torch.from_numpy(v).requires_grad_())
             for k, v in outs.items()}
    priors = make_priors(shapes, port_cfg.strides)
    got = yolox_loss(touts, priors, *[torch.from_numpy(g) for g in gt], rc)
    sum(got[k] for k in sorted(got)).backward()
    tmatched = simota_assign(
        flatten_levels(touts['cls_scores']).detach(),
        flatten_levels(touts['objectnesses'])[..., 0].detach(), priors,
        decode_boxes(priors, flatten_levels(touts['bbox_preds'])).detach(),
        *[torch.from_numpy(g) for g in (gt[0], gt[1], gt[3])], rc)
    return dict(want=want, got={k: float(v.detach()) for k, v in got.items()},
                want_grad=want_grad, touts=touts, jmatched=jmatched,
                tmatched=tmatched)


def test_simota_assignment(yolox_pair):
    jm, jiou = yolox_pair['jmatched']
    tm, tiou = yolox_pair['tmatched']
    assert (np.asarray(jm) >= 0).sum() > 0, 'no positive in the case'
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tiou.detach().numpy(), np.asarray(jiou),
                               rtol=1e-5, atol=1e-6)


def test_yolox_loss_values(yolox_pair):
    want, got = yolox_pair['want'], yolox_pair['got']
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize('key', ['cls_scores', 'bbox_preds', 'objectnesses',
                                 'centers2d_offsets', 'depth_logit'])
def test_yolox_loss_gradients(yolox_pair, key):
    """Including the gradient that reaches the box maps through the matched
    IoU, which scales the class target in the JAX package."""
    want = yolox_pair['want_grad'][key]
    got = yolox_pair['touts'][key]
    if not isinstance(got, list):
        want, got = [want], [got]
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   err_msg=f'{key} level {lvl}', **TOL)


# ------------------------------------------------ 3D set loss and matching

@pytest.fixture(scope='module')
def farhead_pair(cfgs, dn_pair):
    """Random decoder outputs for two batch lanes, with the DN queries of
    `dn_pair`: JAX farhead_loss / match_targets and the port's, with the
    gradients of the summed loss."""
    jax_cfg, port_cfg = cfgs
    jdn, _, jb = dn_pair
    c = jax_cfg.head
    rng = np.random.default_rng(9)
    n_layers, b, q = jax_cfg.decoder.num_layers, 2, 40
    pad = jdn['ref_points'].shape[1]
    lo, hi = np.asarray(jax_cfg.pc_range[:3]), np.asarray(jax_cfg.pc_range[3:])

    def preds(nq):
        xyz = rng.uniform(lo, hi, (n_layers, b, nq, 3))
        rest = rng.standard_normal((n_layers, b, nq, c.code_size - 3)) * 0.5
        return (rng.standard_normal((n_layers, b, nq, c.num_classes)) - 2.0,
                np.concatenate([xyz, rest], -1))

    cls, bbox = preds(q)
    dn_cls, dn_bbox = preds(pad)
    arrays = dict(all_cls_scores=cls, all_bbox_preds=bbox,
                  dn_cls_scores=dn_cls, dn_bbox_preds=dn_bbox)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    qv = rng.random((b, q)) < 0.85
    gt = (jb.gt_boxes, jb.gt_labels, jb.gt_mask)

    def jloss(a):
        outs = dict(a, query_valid=jnp.asarray(qv))
        return jax_losses3d.farhead_loss(outs, *map(jnp.asarray, gt), jdn, c)

    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = {k: float(v) for k, v in jloss(ja).items()}
    want_grad = jax.grad(
        lambda a: sum(jax.tree_util.tree_leaves(jloss(a))))(ja)
    want_match = jax_losses3d.match_targets(
        ja['all_cls_scores'][0], ja['all_bbox_preds'][0], jnp.asarray(qv),
        *map(jnp.asarray, gt), c)

    ta = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
    tgt = _t(*gt)
    dn_q = tdn.build_queries(_jax_dn_draws(jax.random.PRNGKey(2), 2, c), *tgt,
                             port_cfg.head, port_cfg.pc_range)
    got = tl3d.farhead_loss(dict(ta, query_valid=torch.from_numpy(qv)), *tgt,
                            dn_q, port_cfg.head)
    sum(got[k] for k in sorted(got)).backward()
    got_match = tl3d.match_targets(ta['all_cls_scores'][0].detach(),
                                   ta['all_bbox_preds'][0].detach(),
                                   torch.from_numpy(qv), *tgt, port_cfg.head)
    return dict(want=want, got={k: float(v.detach()) for k, v in got.items()},
                want_grad=want_grad, ta=ta, want_match=want_match,
                got_match=got_match)


def test_match_targets(farhead_pair):
    names = ('labels', 'bbox_targets', 'bbox_mask', 'label_weights')
    for name, g, w in zip(names, farhead_pair['got_match'],
                          farhead_pair['want_match']):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert np.asarray(farhead_pair['want_match'][2]).sum() > 0


def test_farhead_loss_values(farhead_pair):
    want, got = farhead_pair['want'], farhead_pair['got']
    assert got.keys() == want.keys()
    assert any('dn_loss' in k for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize('key', ['all_cls_scores', 'all_bbox_preds',
                                 'dn_cls_scores', 'dn_bbox_preds'])
def test_farhead_loss_gradients(farhead_pair, key):
    np.testing.assert_allclose(farhead_pair['ta'][key].grad.numpy(),
                               np.asarray(farhead_pair['want_grad'][key]),
                               err_msg=key, **TOL)


# ------------------------------------------------------ optimizer, schedule

@pytest.mark.parametrize('step', [0, 1, 499, 500, 501, 82547])
def test_lr_schedule(cfgs, step):
    want = float(jax_lr_schedule(cfgs[0].train)(step))
    assert toptim.lr_at(cfgs[1].train, step) == pytest.approx(want, rel=1e-6)


class _ToyModel(torch.nn.Module):
    """Parameters named as the port names the backbone, a head parameter and
    the frozen pseudo reference points."""

    def __init__(self, values):
        super().__init__()
        self.img_backbone = torch.nn.ParameterDict(
            {'w': torch.nn.Parameter(torch.tensor(values['backbone']))})
        self.pts_bbox_head = torch.nn.ParameterDict({
            'w': torch.nn.Parameter(torch.tensor(values['head'])),
            'pseudo_reference_points': torch.nn.Parameter(
                torch.tensor(values['frozen']))})


def test_optimizer_updates_match_optax(cfgs):
    """Two clipped AdamW updates with the backbone multiplier and the frozen
    parameter against the JAX package's optax chain, at a scheduled step
    count past the warm-up: 1e-6 (the same f32 arithmetic)."""
    train = dataclasses.replace(cfgs[0].train, warmup_iters=1)
    rng = np.random.default_rng(0)
    vals = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (('backbone', (4, 3)), ('head', (5,)),
                         ('frozen', (2, 3)))}
    # the frozen parameter's gradient is zero, as its stop_gradient makes it
    grads = [{k: (rng.standard_normal(v.shape) * scale * (k != 'frozen')
                  ).astype(np.float32)
              for k, v in vals.items()} for scale in (30.0, 0.5)]
    jparams = {'backbone': {'w': jnp.asarray(vals['backbone'])},
               'pts_head': {'w': jnp.asarray(vals['head']),
                            'pseudo_reference_points': jnp.asarray(
                                vals['frozen'])}}
    tx = jax_make_optimizer(train, jparams)
    opt_state = tx.init(jparams)
    model = _ToyModel(vals)
    opt = toptim.make_optimizer(model, train)
    params = dict(model.named_parameters())
    for i, g in enumerate(grads):
        jg = {'backbone': {'w': jnp.asarray(g['backbone'])},
              'pts_head': {'w': jnp.asarray(g['head']),
                           'pseudo_reference_points': jnp.asarray(g['frozen'])}}
        want_norm = float(optax.global_norm(jg))
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        # copies: the clip scales the gradients in place
        params['img_backbone.w'].grad = torch.tensor(g['backbone'])
        params['pts_bbox_head.w'].grad = torch.tensor(g['head'])
        norm = toptim.clip_and_step(opt, train, step=i)
        assert float(norm) == pytest.approx(want_norm, rel=1e-5)
    for name, want in (('img_backbone.w', jparams['backbone']['w']),
                       ('pts_bbox_head.w', jparams['pts_head']['w']),
                       ('pts_bbox_head.pseudo_reference_points',
                        jparams['pts_head']['pseudo_reference_points'])):
        np.testing.assert_allclose(params[name].detach().numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert not params['pts_bbox_head.pseudo_reference_points'].requires_grad


def test_ema_update_ramp():
    """step.py:159-165: d = min(decay, (1 + step) / (10 + step))."""
    model = torch.nn.Linear(2, 2)
    ema = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    toptim.ema_update(ema, model, step=0, decay=0.9)
    torch.testing.assert_close(ema['weight'], model.weight.detach() * 0.9)
    toptim.ema_update(ema, model, step=100, decay=0.9)
    torch.testing.assert_close(
        ema['weight'], model.weight.detach() * (0.9 * 0.9 + 0.1))


# -------------------------------------------------- BatchNorm and dropout

def test_batchnorm_flax_semantics():
    """flax.linen.BatchNorm(momentum=0.97, epsilon=1e-3) in training: output
    and running statistics (biased variance) at 1e-5."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 6, 8)) * 2 + 1).astype(np.float32)  # NHWC
    mean0 = rng.standard_normal(8).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32) * 0.1
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    want, mutated = jbn.apply(
        {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {'mean': mean0, 'var': var0}},
        jnp.asarray(x), mutable=['batch_stats'])
    bn = BatchNorm(8)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, t in (('mean', bn.running_mean), ('var', bn.running_var)):
        np.testing.assert_allclose(
            t.numpy(), np.asarray(mutated['batch_stats'][name]), rtol=1e-5,
            atol=1e-6, err_msg=name)


def test_dropout_keep_rate_and_scale():
    """Kept share within 5 sigma of 1 - rate, kept values scaled by
    1 / (1 - rate), identity outside training, reproducible per seed."""
    x = torch.ones(200_000)
    rate = 0.1
    y = dropout(x, rate, True, torch.Generator().manual_seed(0))
    kept = y != 0
    sigma = np.sqrt(rate * (1 - rate) / x.numel())
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert torch.equal(y, dropout(x, rate, True,
                                  torch.Generator().manual_seed(0)))
    assert dropout(x, rate, False, None) is x
    with pytest.raises(ValueError, match='Generator'):
        dropout(x, rate, True, None)


# ------------------------------------------------------------- entry point

def test_train_entry_on_the_cpu(cfgs):
    """train_entry at the tiny size on the CPU when asked: finite metrics,
    the step count advances, the parameters move, the frozen ones do not."""
    from far3d_tpu_torch.entry import train_entry
    step, (state, temporal) = train_entry(cfgs[1], device='cpu')
    params = dict(state.model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    for _ in range(2):
        state, temporal, metrics = step(state, temporal)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.step == 2
    frozen = [k for k in params if 'pseudo_reference_points' in k]
    assert frozen and all(torch.equal(before[k], params[k]) for k in frozen)
    moved = [k for k in params if not torch.equal(before[k], params[k])]
    assert len(moved) == len(params) - len(frozen)
