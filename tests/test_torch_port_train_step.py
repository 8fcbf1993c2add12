"""The port's whole training step (far3d_tpu_torch/train/step.py) against the
JAX package's ``make_train_step``, two steps on shared weights, in f32 on the
CPU at the tiny size, with the 2D proposals at their GT depth and at the
depth net's predicted bins (``use_gt_depth`` True and False, the two sides
of the runner's UseGtDepthHook switch).

Both sides: dropout rates 0 (the two frameworks draw different bits), the
grid mask on and the DN noise drawn by the JAX step's own keys
(``split(fold_in(rng, step), 3)``, step.py:98-99) and handed to the port,
the auction for every matching on both sides (the port's
``auction_match`` is the JAX package's, assignment for assignment:
tests/test_torch_port_matching.py). Every loss term, the grad norm, every
updated parameter and YOLOX BN statistic (mapped back with
``from_jax_variables``) and the next temporal state agree at the composed
parity tolerance (rtol 1e-3 / atol 2e-3): f32 on both sides, the sums taken
in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_setup import TOL, make_cfgs, shared_weights, to_np
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.train.optim import make_optimizer as jax_make_optimizer
from far3d_tpu.train.step import TrainState as JaxTrainState
from far3d_tpu.train.step import make_train_step
from far3d_tpu.utils.synthetic import synthetic_batch as jax_synthetic_batch
from far3d_tpu_torch.models.detector import Far3D
from far3d_tpu_torch.train.step import create_train_state, step_from_noise
from far3d_tpu_torch.utils.convert import from_jax_variables
from far3d_tpu_torch.utils.synthetic import synthetic_batch

STEPS = 2
RNG_SEED = 1          # the grid mask applies at both steps with this key


def train_cfgs():
    """(JAX, port) tiny configs in f32 with every dropout rate 0."""
    out = []
    for cfg in make_cfgs():
        out.append(cfg.replace(
            train=dataclasses.replace(cfg.train, dtype='float32'),
            deform=dataclasses.replace(cfg.deform, dropout=0.0),
            decoder=dataclasses.replace(cfg.decoder, dropout=0.0,
                                        attn_dropout=0.0)))
    return tuple(out)


def jax_step_noise(cfg, key, step):
    """The grid-mask and DN draws of the JAX step number `step`, reproduced
    from its keys (step.py:98-99, grid_mask.py:20-25, dn.py:57-70)."""
    rng_gm, rng_dn, _ = jax.random.split(jax.random.fold_in(key, step), 3)
    k_apply, k_d, k_sh, k_sw = jax.random.split(rng_gm, 4)
    h = cfg.data.input_hw[0]
    d = int(jax.random.randint(k_d, (), 2, h))
    grid = dict(
        apply=bool(jax.random.uniform(k_apply) < cfg.train.grid_mask_prob),
        d=d, st_h=int(jax.random.randint(k_sh, (), 0, d)),
        st_w=int(jax.random.randint(k_sw, (), 0, d)))
    c = cfg.head
    kp, kps, kn, kns = jax.random.split(rng_dn, 4)
    shape_p = (1, c.dn_groups, c.dn_max_gt, 3)
    shape_n = (1, c.dn_groups, c.num_smp_per_gt - 1, c.dn_max_gt, 3)

    def sign(k, shape):
        return jax.random.randint(k, shape, 0, 2).astype(jnp.float32) * 2 - 1

    dn = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        rand_p=jax.random.uniform(kp, shape_p), sign_p=sign(kps, shape_p),
        rand_n=jax.random.uniform(kn, shape_n), sign_n=sign(kns, shape_n)
    ).items()}
    return dict(grid_mask=grid, dn=dn)


# the second step sees the same scene one frame later: the memory carries over
SECOND_FRAME = dict(prev_exists=np.ones((1,), np.float32),
                    timestamp=np.full((1,), 0.5, np.float32))


@pytest.fixture(scope='module', params=[True, False],
                ids=['gt_depth', 'pred_depth'])
def runs(request):
    use_gt_depth = request.param
    jax_cfg, port_cfg = train_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg)
    key = jax.random.PRNGKey(RNG_SEED)

    # JAX: one compiled step
    params = variables['params']
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        stats=variables['stats'], batch_stats=variables['batch_stats'],
        opt_state=jax_make_optimizer(jax_cfg.train, params).init(params),
        ema_params=None)
    jt = jax_init_state(1, jax_cfg.head)
    jbatch = jax_synthetic_batch(jax_cfg, batch=1, seed=6)
    jmetrics = []
    step = jax.jit(make_train_step(jax_cfg, use_gt_depth=use_gt_depth))
    for s in range(STEPS):
        b = jbatch if s == 0 else jbatch.replace(**SECOND_FRAME)
        jstate, jt, m = step(jstate, jt, b, key)
        jmetrics.append({k: float(np.asarray(v)) for k, v in m.items()})

    # port
    model = Far3D(port_cfg)
    model.load_state_dict(sd)
    state, tt = create_train_state(port_cfg, model, batch=1)
    batch = synthetic_batch(port_cfg, batch=1, seed=6)
    tmetrics, noises = [], []
    for s in range(STEPS):
        if s:
            batch.update({k: torch.from_numpy(v)
                          for k, v in SECOND_FRAME.items()})
        noise = jax_step_noise(jax_cfg, key, s)
        noises.append(noise)
        state, tt, m = step_from_noise(port_cfg, state, tt, batch, noise,
                                       use_gt_depth=use_gt_depth)
        tmetrics.append({k: float(v) for k, v in m.items()})
    return dict(jax=(jstate, jt, jmetrics, jbatch), port=(state, tt, tmetrics),
                cfg=port_cfg, noises=noises)


def test_grid_mask_applies(runs):
    assert all(n['grid_mask']['apply'] for n in runs['noises'])


def test_synthetic_batch_matches_jax(runs):
    jbatch = runs['jax'][3]
    got = synthetic_batch(runs['cfg'], batch=1, seed=6)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jbatch, k)),
                                      err_msg=k)


@pytest.mark.parametrize('step', range(STEPS))
def test_losses_and_grad_norm(runs, step):
    want = runs['jax'][2][step]
    got = runs['port'][2][step]
    assert got.keys() == want.keys()
    assert want['total_loss'] > 0
    assert want['enc_loss_iou'] > 0      # SimOTA found 2D positives
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_updated_parameters_and_batch_stats(runs):
    jstate = runs['jax'][0]
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        'params': jstate.params, 'stats': jstate.stats,
        'batch_stats': jstate.batch_stats}), runs['cfg'])
    got = runs['port'][0].model.state_dict()
    assert got.keys() == want.keys()
    assert int(jstate.step) == runs['port'][0].step == STEPS
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), want[k].numpy(), err_msg=k,
                                   **TOL)


def _jax_first_moments(jstate):
    """Adam's first moment (0.1 g1 * 0.9 + 0.1 g2 of the clipped gradients)
    of every parameter, from the optax state, as a full params tree (zeros
    for the frozen pseudo reference points)."""
    import optax
    inner = jstate.opt_state[1].inner_states

    def mu(label):
        return inner[label].inner_state[0].mu

    def pick(main, backbone, p):
        for m in (main, backbone):
            if not isinstance(m, optax.MaskedNode):
                return np.asarray(m)
        return np.zeros_like(np.asarray(p))

    return jax.tree_util.tree_map(
        pick, mu('main'), mu('backbone'), jstate.params,
        is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def test_gradients_through_adam_moments(runs):
    """Adam's first moments are linear in the (clipped) gradients of both
    steps, so they compare the gradients parameter by parameter. Tolerance:
    rtol 1e-3, and atol 2e-3 of the tensor's largest moment, since
    summation-order noise scales with the tensor's gradient magnitude."""
    jstate = runs['jax'][0]
    zeros = jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   {'stats': jstate.stats,
                                    'batch_stats': jstate.batch_stats})
    want = from_jax_variables({'params': _jax_first_moments(jstate), **zeros},
                              runs['cfg'])
    state = runs['port'][0]
    got = {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        got[name] = st['exp_avg'] if 'exp_avg' in st else torch.zeros_like(p)
    assert got.keys() <= want.keys()
    moved = 0
    for k, g in got.items():
        w = want[k].numpy()
        scale = float(np.abs(w).max())
        moved += scale > 0
        np.testing.assert_allclose(to_np(g), w, rtol=1e-3,
                                   atol=max(2e-3 * scale, 1e-12), err_msg=k)
    # all but the 2D branches that SimOTA gave no positive at this size
    assert moved > 0.8 * len(got)


def test_next_temporal_state(runs):
    jt, tt = runs['jax'][1], runs['port'][1]
    for field in ('embedding', 'ref_points', 'timestamp', 'egopose', 'velo'):
        assert not getattr(tt, field).requires_grad
        np.testing.assert_allclose(to_np(getattr(tt, field)),
                                   np.asarray(getattr(jt, field)),
                                   err_msg=field, **TOL)
