"""The port's StreamPETR family (far3d_tpu_torch/models/{petr,streampetr}.py,
train/petr_step.py, the optimizer's layer-wise decay, ops/quant.py's
``quantize_petr_backbone`` and its hook) against the JAX package's, on the
CPU at ``tiny_petr_config()``.

The JAX modules' variables are drawn from numpy seeds (every leaf, so that no
zero-initialized kernel hides a transposed mapping) and carried to the port
by ``utils.convert.petr_from_jax_variables`` (the whole model) or by
``flax_to_port`` below (a lone module, whose port names are the flax tree's).
Tolerances: the composed parity tolerance, rtol 1e-3 / atol 2e-3 (f32 on
both sides, sums in other orders), unless a test says otherwise.

* each ``petr.py`` module (the twins of tests/test_petr.py), including a
  ``key_valid`` row with no valid key;
* two streamed frames of ``StreamPETR``: every layer's cls and boxes and the
  carried ``TemporalState``;
* the ``quant_backbone=`` hook: what reaches the FPN is bitwise the JAX int8
  backbone's output from the same amax;
* two training steps against ``make_petr_train_step`` (dropout 0, grid mask
  on with the JAX step's draws, the auction on both sides): losses, grad
  norm, Adam's first moments, updated parameters, the next temporal state;
* one optimizer step with ``layer_decay = 0.8`` against optax's.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far3d_tpu.config as jcfg
import far3d_tpu.models.petr as jpetr
import far3d_tpu.models.streampetr as jsp
import far3d_tpu_torch.config as tcfg
import far3d_tpu_torch.models.petr as tpetr
import far3d_tpu_torch.models.streampetr as tsp
from _torch_port_setup import TOL, to_np
from far3d_tpu.ops import quant as jq
from far3d_tpu.train.optim import make_optimizer as jax_make_optimizer
from far3d_tpu.train.petr_step import make_petr_train_step
from far3d_tpu.train.step import TrainState as JaxTrainState
from far3d_tpu.utils.synthetic import synthetic_batch as jax_synthetic_batch
from far3d_tpu_torch.ops import quant as tq
from far3d_tpu_torch.train import optim as toptim
from far3d_tpu_torch.train.petr_step import (create_petr_train_state,
                                             petr_step_from_noise)
from far3d_tpu_torch.utils.convert import (petr_from_jax_variables,
                                           petr_init_state_dict,
                                           random_petr_state_dict)
from far3d_tpu_torch.utils.synthetic import petr_synthetic_batch


def random_leaves(shapes, seed):
    """A numpy value for every leaf of a flax variable tree of shapes: BN
    statistics and norm scales near their neutral values, reference points
    in [0, 1], kernels fan-in scaled, biases small."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        keys = [str(getattr(p, 'key', p)) for p in path]
        leaf, shp = keys[-1], s.shape
        if leaf == 'var':
            v = rng.uniform(0.5, 1.5, shp)
        elif leaf == 'mean':
            v = rng.standard_normal(shp) * 0.1
        elif 'reference_points' in leaf:
            v = rng.uniform(0.0, 1.0, shp)
        elif leaf == 'scale':
            v = rng.uniform(0.75, 1.25, shp)
        elif leaf == 'kernel':
            out = keys[-2] in ('out', 'out_proj')
            fan = (shp[0] * (shp[1] if out else 1) if len(shp) == 3
                   else int(np.prod(shp[:-1])))
            v = rng.standard_normal(shp) / np.sqrt(fan)
        else:
            v = rng.standard_normal(shp) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flax_to_port(tree, prefix=''):
    """A lone petr.py module's flax params -> its port state dict (the same
    names; kernels to torch's layout, FFN fc1 / fc2 to layers.0.0 /
    layers.1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            name = {'fc1': 'layers.0.0', 'fc2': 'layers.1'}.get(k, k) \
                if prefix.endswith('ffn.') else k
            out.update(flax_to_port(v, prefix + name + '.'))
            continue
        v = np.asarray(v, np.float32)
        if k == 'kernel':
            parent = prefix.rstrip('.').split('.')[-1]
            if v.ndim == 3 and parent in ('out', 'out_proj'):
                v = v.reshape(-1, v.shape[-1]).T
            else:
                v = v.reshape(v.shape[0], -1).T
            k = 'weight'
        elif k == 'scale':
            k = 'weight'
        else:
            v = v.reshape(-1)
        out[prefix + k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def init_pair(jmod, tmod, *args, seed=0, **kw):
    """(flax variables with random leaves, the port module holding them)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              **kw))
    variables = random_leaves(shapes, seed)
    tmod.load_state_dict(flax_to_port(variables['params']))
    return variables, tmod.eval()


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_configs_match_jax():
    for name in ('StreamPETRConfig', 'tiny_petr_config'):
        assert dataclasses.asdict(getattr(tsp, name)()) == \
            dataclasses.asdict(getattr(jsp, name)()), name


# ------------------------------------------------------------ petr.py modules
def test_petr_temporal_transformer_matches_jax():
    b, q, n_tok, c = 2, 16, 64, 32
    rng = np.random.RandomState(0)
    args = [rng.randn(*s).astype(np.float32) for s in
            ((b, q, c), (b, q, c), (b, n_tok, c), (b, n_tok, c), (b, 8, c),
             (b, 8, c))]
    jm = jpetr.PETRTemporalTransformer(embed_dims=c, num_layers=2,
                                       num_heads=4, ffn_dims=64)
    variables, tm = init_pair(jm, tpetr.PETRTemporalTransformer(
        c, 2, 4, 64), *map(jnp.asarray, args))
    want = jax.jit(jm.apply)(variables, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tm(*map(t, args))
    assert got.shape == (2, b, q, c)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_frustum_pe_matches_jax():
    b, n = 1, 2
    rng = np.random.RandomState(1)
    img2lidar = np.linalg.inv(np.tile(np.diag([40.0, 40.0, 1.0, 1.0]),
                                      (b, n, 1, 1)) + rng.randn(b, n, 4, 4)
                              * 0.05).astype(np.float32)
    jm = jpetr.FrustumPE(embed_dims=32, depth_num=8)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (8, 12),
                                            (64, 96), jnp.asarray(img2lidar)))
    variables = random_leaves(shapes, 1)
    tm = tpetr.FrustumPE(32, 8)
    tm.load_state_dict(flax_to_port(variables['params']))
    want = jax.jit(jm.apply, static_argnums=(1, 2))(
        variables, (8, 12), (64, 96), jnp.asarray(img2lidar))
    with torch.no_grad():
        got = tm((8, 12), (64, 96), t(img2lidar))
    assert got.shape == (b * n, 8 * 12, 32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_petr_transformer_non_temporal_matches_jax():
    """Encoder + decoder with the shared post-norm and key_valid; batch row
    1 has no valid key at all: both sides attend uniformly there (-1e9)."""
    rng = np.random.RandomState(0)
    b, n_tok, q, c = 2, 40, 8, 32
    feats, pos = (rng.randn(b, n_tok, c).astype(np.float32) for _ in '12')
    qemb = rng.randn(q, c).astype(np.float32)
    valid = np.ones((b, n_tok), bool)
    valid[0, 30:] = False
    valid[1] = False
    jm = jpetr.PETRTransformer(embed_dims=c, num_layers=2,
                               num_encoder_layers=1, num_heads=4, ffn_dims=64)
    variables, tm = init_pair(
        jm, tpetr.PETRTransformer(c, 2, 1, 4, 64), jnp.asarray(feats),
        jnp.asarray(pos), jnp.asarray(qemb), key_valid=jnp.asarray(valid))
    want = jax.jit(jm.apply)(variables, jnp.asarray(feats), jnp.asarray(pos),
                             jnp.asarray(qemb), key_valid=jnp.asarray(valid))
    with torch.no_grad():
        got = tm(t(feats), t(pos), t(qemb), key_valid=t(valid))
    assert got.shape == (2, b, q, c)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_flash_mha_matches_jax():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, n, 32).astype(np.float32)
               for n in (5, 9, 9))
    valid = rng.rand(2, 9) > 0.4
    jm = jpetr.FlashMHA(embed_dims=32, num_heads=4)
    variables, tm = init_pair(jm, tpetr.FlashMHA(32, 4), jnp.asarray(q),
                              jnp.asarray(k), jnp.asarray(v))
    for kv in (None, valid):
        want = jax.jit(jm.apply)(variables, jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), key_valid=None if kv is None
                                 else jnp.asarray(kv))
        with torch.no_grad():
            got = tm(t(q), t(k), t(v), None if kv is None else t(kv))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_multi_head_attention_matches_flax():
    """The decoder's self-attention against flax's
    MultiHeadDotProductAttention, with and without a mask."""
    rng = np.random.RandomState(3)
    x, kv = rng.randn(2, 6, 32).astype(np.float32), \
        rng.randn(2, 10, 32).astype(np.float32)
    mask = rng.rand(2, 1, 6, 10) > 0.3
    jm = fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=32)
    variables, tm = init_pair(jm, tpetr.MultiHeadAttention(32, 4),
                              jnp.asarray(x), jnp.asarray(kv),
                              jnp.asarray(kv))
    for m in (None, mask):
        want = jax.jit(jm.apply)(variables, jnp.asarray(x), jnp.asarray(kv),
                                 jnp.asarray(kv),
                                 mask=None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = tm(t(x), t(kv), t(kv), None if m is None else t(m))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_flatten_mh_self_attention_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(10, 1, 16).astype(np.float32)
    jm = jpetr.FlattenMHSelfAttention(embed_dims=16, num_heads=4, dropout=0.0)
    variables, tm = init_pair(jm, tpetr.FlattenMHSelfAttention(16, 4, 0.0),
                              jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_sine_positional_encoding_2d_matches_jax():
    want = jpetr.sine_positional_encoding_2d(5, 7, num_feats=16)
    got = tpetr.sine_positional_encoding_2d(5, 7, num_feats=16)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- StreamPETR
def petr_frame(cfg, seed, b=1):
    """A frame of two cameras looking +x and -x, the ego moving +x."""
    n, (h, w) = cfg.num_cams, cfg.input_hw
    r = np.random.RandomState(seed)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 40.0
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    fwd = np.eye(4, dtype=np.float32)
    fwd[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    back = fwd @ np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    l2i = np.stack([intr @ fwd, intr @ back])[None].repeat(b, 0)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, 0, 3] = 0.3 * seed
    return dict(images=r.randn(b, n, h, w, 3).astype(np.float32),
                lidar2img=l2i.astype(np.float32),
                timestamp=np.full((b,), 0.5 * seed, np.float32),
                ego_pose=pose, ego_pose_inv=np.linalg.inv(pose).astype(
                    np.float32),
                prev_exists=np.full((b,), float(seed > 0), np.float32))


@pytest.fixture(scope='module')
def petr_pair():
    """(JAX config, port config, JAX variables, port model on them)."""
    jc, tc = jsp.tiny_petr_config(), tsp.tiny_petr_config()
    f0 = {k: jnp.asarray(v) for k, v in petr_frame(jc, 0).items()}
    shapes = jax.eval_shape(lambda: jsp.StreamPETR(jc).init(
        jax.random.PRNGKey(0), state=jsp.init_petr_state(1, jc), **f0))
    variables = random_leaves(shapes, 0)
    model = tsp.StreamPETR(tc)
    model.load_state_dict(petr_from_jax_variables(variables, tc))
    return jc, tc, variables, model.eval()


@pytest.fixture(scope='module')
def two_frames(petr_pair):
    jc, tc, variables, model = petr_pair
    step = jax.jit(lambda v, st, fr: jsp.StreamPETR(jc).apply(
        v, state=st, **fr))
    js, ts = jsp.init_petr_state(1, jc), tsp.init_petr_state(1, tc)
    out = []
    for s in range(2):
        fr = petr_frame(jc, s)
        want = step(variables, js, {k: jnp.asarray(v) for k, v in fr.items()})
        with torch.no_grad():
            got = model(state=ts, **{k: t(v) for k, v in fr.items()})
        js, ts = want['state'], got['state']
        out.append((want, got))
    return out


def test_state_dict_keys(petr_pair):
    _, tc, _, model = petr_pair
    keys = set(model.state_dict())
    assert set(random_petr_state_dict(tc)) == keys
    assert set(petr_init_state_dict(tc)) == keys


@pytest.mark.parametrize('level', [0, 1, 2])
def test_fpn_one_level_is_the_full_necks(petr_pair, level):
    """``FPN(stages, level=k)``, which StreamPETR calls for the one level it
    reads, is bitwise output k of the whole neck; the stages have odd sizes,
    so the top-down sums crop."""
    _, tc, _, model = petr_pair
    rng = np.random.RandomState(7)
    stages = [torch.from_numpy(rng.randn(2, c, -(-20 >> i), -(-25 >> i))
                               .astype(np.float32))
              for i, c in enumerate(tc.neck.in_channels)]
    with torch.no_grad():
        full = model.img_neck(stages)
        one = model.img_neck(stages, level=level)
    assert torch.equal(one, full[level])


@pytest.mark.parametrize('frame', [0, 1])
@pytest.mark.parametrize('name', ['all_cls_scores', 'all_bbox_preds'])
def test_streampetr_frames_match_jax(two_frames, frame, name):
    want, got = two_frames[frame]
    assert got[name].shape == want[name].shape
    np.testing.assert_allclose(to_np(got[name]), np.asarray(want[name]),
                               err_msg=name, **TOL)


@pytest.mark.parametrize('frame', [0, 1])
def test_streampetr_temporal_state_matches_jax(two_frames, frame):
    want, got = two_frames[frame]
    for field in ('embedding', 'ref_points', 'timestamp', 'egopose', 'velo'):
        np.testing.assert_allclose(to_np(getattr(got['state'], field)),
                                   np.asarray(getattr(want['state'], field)),
                                   err_msg=field, **TOL)


def test_quant_backbone_hook_matches_jax(petr_pair):
    """Two streamed uint8 frames through the int8 backbone, finite; the
    stages that reach the FPN at the second are bitwise the JAX package's,
    from the same amax (its calibration on the first); the port's
    ``quantize_petr_backbone`` folds the same module-level mean and std and
    calibrates within 1e-2 of JAX's."""
    jc, tc, variables, model = petr_pair
    rng = np.random.RandomState(5)
    frames = [petr_frame(jc, s) for s in range(2)]
    for f in frames:
        f['images'] = rng.randint(0, 256, f['images'].shape).astype(np.uint8)
    mean, std = jcfg.IMG_MEAN, jcfg.IMG_STD
    assert (mean, std) == (tcfg.IMG_MEAN, tcfg.IMG_STD)

    def normalized(images):
        return jnp.asarray((images[0].astype(np.float32) - np.asarray(mean))
                           / np.asarray(std), jnp.bfloat16)

    jvars = {'params': variables['params']['backbone'],
             'stats': variables['stats']['backbone']}
    amax = jq.calibrate_vovnet(jc.backbone, jvars,
                               [normalized(frames[0]['images'])])
    jtree = jq.build_quant_vovnet(jc.backbone, jvars, amax, mean, std)
    ttree = tq.build_quant_vovnet(model.img_backbone, amax, mean, std)
    own = tq.quantize_petr_backbone(model, [t(frames[0]['images'])])
    assert float(own['s0']) == float(jtree['s0']) == pytest.approx(
        jq.input_scale_from_norm(mean, std))
    for s in range(2, 6):
        np.testing.assert_allclose(float(own[f'stage{s}_scale']),
                                   float(jtree[f'stage{s}_scale']), rtol=1e-2)

    neck_in = []
    hook = model.img_neck.register_forward_pre_hook(
        lambda m, args: neck_in.append(args[0]))
    try:
        ts = tsp.init_petr_state(1, tc)
        for f in frames:
            with torch.no_grad():
                got = model(state=ts, quant_backbone=ttree,
                            **{k: t(v) for k, v in f.items()})
            ts = got['state']
            assert all(torch.isfinite(got[k]).all()
                       for k in ('all_cls_scores', 'all_bbox_preds'))
    finally:
        hook.remove()
    jstages = jax.jit(lambda q, x: jq.quant_vovnet_forward(jc.backbone, q, x))(
        jtree, jq.quantize_input(normalized(frames[1]['images']), jtree['s0']))
    assert len(neck_in) == 2 and len(neck_in[1]) == len(jstages) == 4
    for a, b in zip(neck_in[1], jstages):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.permute(0, 2, 3, 1).float().numpy(),
                                      np.asarray(b, np.float32))


# -------------------------------------------------------------- train step
STEPS = 2
RNG_SEED = 3        # the grid mask applies at both steps with this key
SECOND_FRAME = dict(prev_exists=np.ones((1,), np.float32),
                    timestamp=np.full((1,), 0.5, np.float32))


def jax_petr_noise(cfg, train_cfg, key, step):
    """The grid-mask draw of the JAX StreamPETR step number `step`
    (petr_step.py:66-79, grid_mask.py:20-25)."""
    rng_gm, _ = jax.random.split(jax.random.fold_in(key, step))
    k_apply, k_d, k_sh, k_sw = jax.random.split(rng_gm, 4)
    d = int(jax.random.randint(k_d, (), 2, cfg.input_hw[0]))
    return dict(grid_mask=dict(
        apply=bool(jax.random.uniform(k_apply) < train_cfg.grid_mask_prob),
        d=d, st_h=int(jax.random.randint(k_sh, (), 0, d)),
        st_w=int(jax.random.randint(k_sw, (), 0, d))))


def _petr_shim(cfg):
    return jcfg.Far3DConfig(
        pc_range=cfg.pc_range, num_classes=cfg.num_classes,
        data=jcfg.DataConfig(num_cams=cfg.num_cams,
                             input_hw=tuple(cfg.input_hw), max_gt=8,
                             max_gt_2d=8))


@pytest.fixture(scope='module')
def train_runs(petr_pair):
    jc0, tc0, variables, _ = petr_pair
    jc = dataclasses.replace(jc0, dropout=0.0)
    tc = dataclasses.replace(tc0, dropout=0.0)
    jtrain = dataclasses.replace(jcfg.TrainConfig(), lr=2e-3, warmup_iters=1,
                                 dtype='float32', ema_decay=0.0)
    ttrain = tcfg.TrainConfig(**dataclasses.asdict(jtrain))
    key = jax.random.PRNGKey(RNG_SEED)

    params = variables['params']
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        stats=variables['stats'], batch_stats={},
        opt_state=jax_make_optimizer(jtrain, params).init(params),
        ema_params=None)
    jt = jsp.init_petr_state(1, jc)
    jbatch = jax_synthetic_batch(_petr_shim(jc), batch=1, seed=6)
    jmetrics = []
    step = jax.jit(make_petr_train_step(jc, jtrain))
    for s in range(STEPS):
        b = jbatch if s == 0 else jbatch.replace(**SECOND_FRAME)
        jstate, jt, m = step(jstate, jt, b, key)
        jmetrics.append({k: float(np.asarray(v)) for k, v in m.items()})

    model = tsp.StreamPETR(tc)
    model.load_state_dict(petr_from_jax_variables(variables, tc))
    state, tt = create_petr_train_state(model, ttrain, batch=1)
    batch = petr_synthetic_batch(tc, batch=1, seed=6)
    tmetrics, noises = [], []
    for s in range(STEPS):
        if s:
            batch.update({k: torch.from_numpy(v)
                          for k, v in SECOND_FRAME.items()})
        noise = jax_petr_noise(jc, jtrain, key, s)
        noises.append(noise)
        state, tt, m = petr_step_from_noise(tc, ttrain, state, tt, batch,
                                            noise)
        tmetrics.append({k: float(v) for k, v in m.items()})
    return dict(jax=(jstate, jt, jmetrics, jbatch), port=(state, tt, tmetrics),
                cfg=tc, noises=noises, batch=batch)


def test_petr_batch_matches_jax(train_runs):
    jbatch = train_runs['jax'][3]
    got = petr_synthetic_batch(train_runs['cfg'], batch=1, seed=6)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jbatch, k)),
                                      err_msg=k)
    assert all(n['grid_mask']['apply'] for n in train_runs['noises'])


@pytest.mark.parametrize('step', range(STEPS))
def test_petr_losses_and_grad_norm(train_runs, step):
    want = train_runs['jax'][2][step]
    got = train_runs['port'][2][step]
    assert got.keys() == want.keys()
    assert want['total_loss'] > 0 and want['loss_bbox'] > 0
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def _moments(label_tree, opt_inner, params):
    """Adam's first moment of every parameter from an optax
    multi_transform state, zeros for the frozen ones."""
    import optax
    mus = [opt_inner[lab].inner_state[0].mu for lab in label_tree]

    def pick(p, *ms):
        for m in ms:
            if not isinstance(m, optax.MaskedNode):
                return np.asarray(m)
        return np.zeros_like(np.asarray(p))

    return jax.tree_util.tree_map(
        pick, params, *mus, is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def _port_moments(state_or_opt, model):
    opt = getattr(state_or_opt, 'optimizer', state_or_opt)
    out = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p, {})
        out[name] = st['exp_avg'] if 'exp_avg' in st else torch.zeros_like(p)
    return out


def _assert_moments(got, want):
    """rtol 1e-3 and atol 2e-3 of the tensor's largest moment (summation
    noise scales with the gradient's size), at least 1e-8 (a gradient that
    is zero in exact arithmetic, as the frustum PE's output bias has, whose
    shift of every key's score the softmax cancels); returns how many
    moved."""
    moved = 0
    for k, g in got.items():
        w = want[k].numpy()
        scale = float(np.abs(w).max())
        moved += scale > 0
        np.testing.assert_allclose(to_np(g), w, rtol=1e-3,
                                   atol=max(2e-3 * scale, 1e-8), err_msg=k)
    return moved


def test_petr_gradients_through_adam_moments(train_runs):
    jstate = train_runs['jax'][0]
    mu = _moments(('main', 'backbone'), jstate.opt_state[1].inner_states,
                  jstate.params)
    zeros = jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   jstate.stats)
    want = petr_from_jax_variables({'params': mu, 'stats': zeros},
                                   train_runs['cfg'])
    state = train_runs['port'][0]
    got = _port_moments(state, state.model)
    _assert_moments(got, want)
    # every parameter with a gradient moved: all but the frozen points and
    # the FPN convs whose levels StreamPETR does not read (it takes level
    # feat_level = 1, which the top-down path feeds from laterals 1 and 2)
    still = {k for k, g in got.items() if not bool(g.abs().max() > 0)}
    assert still == {'pts_bbox_head.pseudo_reference_points'} | {
        f'img_neck.{m}.conv.{p}' for p in ('weight', 'bias') for m in (
            'lateral_convs.0', 'fpn_convs.0', 'fpn_convs.2', 'fpn_convs.3')}
    assert not state.model.pts_bbox_head.pseudo_reference_points.requires_grad


def test_petr_updated_parameters(train_runs):
    jstate = train_runs['jax'][0]
    want = petr_from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        'params': jstate.params, 'stats': jstate.stats}), train_runs['cfg'])
    got = train_runs['port'][0].model.state_dict()
    assert got.keys() == want.keys()
    assert int(jstate.step) == train_runs['port'][0].step == STEPS
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), want[k].numpy(), err_msg=k,
                                   **TOL)


def test_petr_next_temporal_state(train_runs):
    jt, tt = train_runs['jax'][1], train_runs['port'][1]
    for field in ('embedding', 'ref_points', 'timestamp', 'egopose', 'velo'):
        assert not getattr(tt, field).requires_grad
        np.testing.assert_allclose(to_np(getattr(tt, field)),
                                   np.asarray(getattr(jt, field)),
                                   err_msg=field, **TOL)


def test_layer_decay_step_matches_optax(petr_pair):
    """One clipped AdamW step with layer_decay = 0.8 (a group per backbone
    depth at lr x 0.8^(4 - depth), the rest at lr, the backbone multiplier
    unused, the frozen points untouched) on the tiny model's parameters and
    seeded gradients (zero for the frozen points, as their stop_gradient
    makes them), against the JAX package's make_optimizer: updated
    parameters at 1e-6, Adam's moments at the train-step tolerance."""
    jc, tc, variables, _ = petr_pair
    jtrain = dataclasses.replace(jcfg.TrainConfig(), layer_decay=0.8, lr=1e-3,
                                 warmup_iters=1)
    ttrain = tcfg.TrainConfig(**dataclasses.asdict(jtrain))
    rng = np.random.default_rng(7)
    params = variables['params']
    grads = jax.tree_util.tree_map_with_path(
        lambda path, p: (rng.standard_normal(p.shape) * (
            'pseudo_reference_points' not in jax.tree_util.keystr(path))
        ).astype(np.float32), params)
    tx = jax_make_optimizer(jtrain, params)
    opt_state = tx.init(params)
    updates, opt_state = jax.jit(tx.update)(grads, opt_state, params)
    new_params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u),
                                        params, updates)

    model = tsp.StreamPETR(tc)
    model.load_state_dict(petr_from_jax_variables(variables, tc))
    opt = toptim.make_optimizer(model, ttrain)
    assert sorted(g['lr_mult'] for g in opt.param_groups) == pytest.approx(
        sorted(0.8 ** (4 - d) for d in range(5)))
    zeros = jax.tree_util.tree_map(np.zeros_like, variables['stats'])
    tgrads = petr_from_jax_variables({'params': grads, 'stats': zeros}, tc)
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = tgrads[name].clone()
    toptim.clip_and_step(opt, ttrain, step=0)

    want = petr_from_jax_variables({'params': new_params,
                                    'stats': variables['stats']}, tc)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    labels = tuple(f'layer_{i}' for i in range(5))
    mu = _moments(labels, opt_state[1].inner_states, params)
    want_mu = petr_from_jax_variables({'params': mu, 'stats': zeros}, tc)
    assert _assert_moments(_port_moments(opt, model), want_mu) == \
        len(list(model.parameters())) - 1        # all but the frozen points
