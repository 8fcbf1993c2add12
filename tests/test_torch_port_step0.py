"""The step-0 gradient norm from the training initialization, the port
against the JAX package, at the tiny size in f32 on the CPU.

From ``utils/convert.py:init_state_dict`` (Far3D) and
``petr_init_state_dict`` (StreamPETR), converted to the JAX variables, one
JAX step (``make_train_step`` / ``make_petr_train_step``) and one port step
run on the same batch and draws, dropout 0, the auction matching on both
sides. The total gradient norm and the 10 parameters with the largest
gradient norms (by name, unclipped) agree at the composed parity tolerance
(rtol 1e-3 / atol 2e-3).

Both norms are far above the clip norm of 35 from these weights, the JAX
step's as much as the port's: at step 0 the gradient sits in the zero-kernel
``beta`` of the memory queries' MLN (``ego_pose_memory``) and in the first
decoder layer's self-attention biases. The clip bounds the update. The same
three-way comparison at full width, with the JAX package's own flax
initializers as the third, is ``tests/_step0_grad_norm.py`` (ROADMAP.md §3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far3d_tpu.config as jcfg
import far3d_tpu.models.streampetr as jsp
import far3d_tpu_torch.config as tcfg
import far3d_tpu_torch.models.streampetr as tsp
from _torch_port_setup import TOL, jax_variable_template
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.train.optim import make_optimizer as jax_make_optimizer
from far3d_tpu.train.petr_step import make_petr_train_step
from far3d_tpu.train.step import TrainState as JaxTrainState
from far3d_tpu.train.step import make_train_step
from far3d_tpu.utils.synthetic import synthetic_batch as jax_synthetic_batch
from far3d_tpu.utils.torch_convert import convert_state_dict
from far3d_tpu_torch.models.detector import Far3D
from far3d_tpu_torch.train.petr_step import (create_petr_train_state,
                                             petr_step_from_noise)
from far3d_tpu_torch.train.step import create_train_state, step_from_noise
from far3d_tpu_torch.utils.convert import (_petr_mapping, from_jax_variables,
                                           init_state_dict,
                                           petr_from_jax_variables,
                                           petr_init_state_dict)
from far3d_tpu_torch.utils.synthetic import (petr_synthetic_batch,
                                             synthetic_batch)
from test_torch_port_petr import _moments, _petr_shim, jax_petr_noise, petr_frame
from test_torch_port_train_step import (_jax_first_moments, jax_step_noise,
                                        train_cfgs)

TOP = 10


def unclipped_norms(clipped, total, clip):
    """Per-parameter norms of the gradient before the global-norm clip,
    from the clipped gradients (scaled by clip / total when total > clip)."""
    scale = max(total / clip, 1.0)
    return {k: float(np.linalg.norm(np.asarray(v, np.float64))) * scale
            for k, v in clipped.items()}


def hold(got_total, want_total, got, want):
    np.testing.assert_allclose(got_total, want_total, **TOL)
    top = sorted(want, key=want.get, reverse=True)[:TOP]
    assert set(sorted(got, key=got.get, reverse=True)[:TOP]) == set(top)
    for k in top:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    return top


def test_far3d_step0_grad_norm_from_init_state_dict():
    jax_cfg, port_cfg = train_cfgs()
    sd = init_state_dict(port_cfg, seed=0)
    converted, missing = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jax_cfg,
        jax_variable_template(jax_cfg))
    assert not missing
    variables = jax.tree_util.tree_map(jnp.asarray, converted)
    key = jax.random.PRNGKey(1)

    params = variables['params']
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        stats=variables['stats'], batch_stats=variables['batch_stats'],
        opt_state=jax_make_optimizer(jax_cfg.train, params).init(params),
        ema_params=None)
    jstate, _, m = jax.jit(make_train_step(jax_cfg, use_gt_depth=True))(
        jstate, jax_init_state(1, jax_cfg.head),
        jax_synthetic_batch(jax_cfg, batch=1, seed=6), key)
    want_total = float(np.asarray(m['grad_norm']))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   {'stats': jstate.stats,
                                    'batch_stats': jstate.batch_stats})
    mu = from_jax_variables({'params': _jax_first_moments(jstate), **zeros},
                            port_cfg)
    clip = jax_cfg.train.grad_clip_norm
    want = unclipped_norms({k: v.numpy() / 0.1 for k, v in mu.items()},
                           want_total, clip)

    model = Far3D(port_cfg)
    model.load_state_dict(sd)
    state, tt = create_train_state(port_cfg, model, batch=1)
    _, _, got_m = step_from_noise(port_cfg, state, tt,
                                  synthetic_batch(port_cfg, batch=1, seed=6),
                                  jax_step_noise(jax_cfg, key, 0))
    got_total = float(got_m['grad_norm'])
    got = unclipped_norms({n: p.grad.numpy() for n, p in
                           model.named_parameters() if p.grad is not None},
                          got_total, clip)
    top = hold(got_total, want_total, got, want)
    assert want_total > 1e3 * clip
    assert top[0] == 'pts_bbox_head.ego_pose_memory.beta.weight'


def _petr_variables_from_port(sd, cfg, template):
    """The port's StreamPETR state dict -> the JAX variable tree (the
    inverse of ``petr_from_jax_variables`` on `template`'s leaves)."""
    out = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                 template)
    for path, key, kind in _petr_mapping(cfg):
        node = out
        for k in path[:-1]:
            node = node[k]
        v, shape = sd[key].numpy(), node[path[-1]].shape
        if kind == 'conv':
            v = np.transpose(v, (2, 3, 1, 0))
        elif kind in ('lin', 'heads_in') or kind.startswith('mha_out_w'):
            v = v.T
        node[path[-1]] = np.ascontiguousarray(v.reshape(shape))
    return jax.tree_util.tree_map(jnp.asarray, out)


def test_petr_step0_grad_norm_from_petr_init_state_dict():
    jc = dataclasses.replace(jsp.tiny_petr_config(), dropout=0.0)
    tc = dataclasses.replace(tsp.tiny_petr_config(), dropout=0.0)
    jtrain = dataclasses.replace(jcfg.TrainConfig(), lr=2e-3, warmup_iters=1,
                                 dtype='float32', ema_decay=0.0)
    ttrain = tcfg.TrainConfig(**dataclasses.asdict(jtrain))
    f0 = {k: jnp.asarray(v) for k, v in petr_frame(jc, 0).items()}
    template = jax.eval_shape(lambda: jsp.StreamPETR(jc).init(
        jax.random.PRNGKey(0), state=jsp.init_petr_state(1, jc), **f0))
    sd = petr_init_state_dict(tc, seed=0)
    variables = _petr_variables_from_port(sd, tc, template)
    back = petr_from_jax_variables(variables, tc)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    key = jax.random.PRNGKey(3)

    params = variables['params']
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        stats=variables['stats'], batch_stats={},
        opt_state=jax_make_optimizer(jtrain, params).init(params),
        ema_params=None)
    jstate, _, m = jax.jit(make_petr_train_step(jc, jtrain))(
        jstate, jsp.init_petr_state(1, jc),
        jax_synthetic_batch(_petr_shim(jc), batch=1, seed=6), key)
    want_total = float(np.asarray(m['grad_norm']))
    mu = _moments(('main', 'backbone'), jstate.opt_state[1].inner_states,
                  jstate.params)
    zeros = jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   jstate.stats)
    mu = petr_from_jax_variables({'params': mu, 'stats': zeros}, tc)
    clip = jtrain.grad_clip_norm
    want = unclipped_norms({k: v.numpy() / 0.1 for k, v in mu.items()},
                           want_total, clip)

    model = tsp.StreamPETR(tc)
    model.load_state_dict(sd)
    state, tt = create_petr_train_state(model, ttrain, batch=1)
    _, _, got_m = petr_step_from_noise(
        tc, ttrain, state, tt, petr_synthetic_batch(tc, batch=1, seed=6),
        jax_petr_noise(jc, jtrain, key, 0))
    got_total = float(got_m['grad_norm'])
    got = unclipped_norms({n: p.grad.numpy() for n, p in
                           model.named_parameters() if p.grad is not None},
                          got_total, clip)
    hold(got_total, want_total, got, want)
