"""The step-0 gradient norm of Far3D three ways, on the CPU:

  * the JAX package from flax's own initializers (``create_train_state``);
  * the JAX package from the port's ``init_state_dict`` weights, converted;
  * the port from ``init_state_dict``.

One training step each on ``synthetic_batch(cfg, 1, 6)`` with the JAX
step's draws of key 1, f32, dropout 0, scipy matching on both sides (so
that the three see the same assignment rule). Prints the three norms, the
10 parameters with the largest unclipped gradient norms of each, and the
losses, and writes them to --out as JSON.

    JAX_PLATFORMS=cpu python tests/_step0_grad_norm.py --size wide \\
        --out step0.json

``--size tiny`` is the test config; ``--size wide`` is ``Far3DConfig()``'s
widths, budgets and query counts with 2 cameras of 256 x 384 instead of 7 of
640 x 960, so that the JAX step fits a shared CPU's memory (about 10 GiB,
8 minutes). tests/test_torch_port_step0.py holds the last two at the tiny
size in tier-1.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--size', choices=('tiny', 'wide'), default='wide')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    import numpy as np
    import torch

    import far3d_tpu.config as jcfg
    import far3d_tpu_torch.config as tcfg
    from _torch_port_setup import jax_variable_template
    from far3d_tpu.models.farhead import init_state as jax_init_state
    from far3d_tpu.train import dn as jax_dn
    from far3d_tpu.train import losses3d as jax_losses3d
    from far3d_tpu.train.matching import BIG_COST, hungarian_match_callback
    from far3d_tpu.train.optim import make_optimizer as jax_make_optimizer
    from far3d_tpu.train.step import TrainState as JaxTrainState
    from far3d_tpu.train.step import create_train_state as jax_create_state
    from far3d_tpu.train.step import make_train_step
    from far3d_tpu.utils.synthetic import synthetic_batch as jax_batch
    from far3d_tpu.utils.torch_convert import convert_state_dict
    from far3d_tpu_torch.models.detector import Far3D
    from far3d_tpu_torch.train import dn as port_dn
    from far3d_tpu_torch.train import losses3d as port_losses3d
    from far3d_tpu_torch.train.matching import lsa_host
    from far3d_tpu_torch.train.step import (create_train_state,
                                            step_from_noise)
    from far3d_tpu_torch.utils.convert import (from_jax_variables,
                                               init_state_dict)
    from far3d_tpu_torch.utils.synthetic import synthetic_batch
    from test_torch_port_step0 import unclipped_norms
    from test_torch_port_train_step import _jax_first_moments, jax_step_noise

    def config(mod):
        c = (mod.tiny_test_config() if args.size == 'tiny'
             else mod.Far3DConfig())
        if args.size == 'wide':
            c = c.replace(
                data=dataclasses.replace(c.data, num_cams=2,
                                         input_hw=(256, 384)),
                deform=dataclasses.replace(c.deform, num_cams=2))
        if mod is jcfg:
            c = c.replace(deform=dataclasses.replace(c.deform,
                                                     use_pallas=False))
        return c.replace(
            train=dataclasses.replace(c.train, dtype='float32'),
            deform=dataclasses.replace(c.deform, dropout=0.0),
            decoder=dataclasses.replace(c.decoder, dropout=0.0,
                                        attn_dropout=0.0))

    jc, pc = config(jcfg), config(tcfg)
    key = jax.random.PRNGKey(1)
    clip = jc.train.grad_clip_norm

    def jax_scipy(cost, col_valid=None):
        if col_valid is not None:
            cost = jnp.where(col_valid[..., None, :], cost, BIG_COST)
        return hungarian_match_callback(cost)

    def port_scipy(costs, col_valid):
        out = []
        for c, v in zip(costs, col_valid):
            c = torch.where(v[..., None, :], c.detach().float(), BIG_COST)
            out.append(torch.from_numpy(lsa_host(c.cpu().numpy())))
        return out

    def jax_step(variables):
        params = variables['params']
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            stats=variables['stats'], batch_stats=variables['batch_stats'],
            opt_state=jax_make_optimizer(jc.train, params).init(params),
            ema_params=None)
        with mock.patch.object(jax_losses3d, 'hungarian_match', jax_scipy), \
                mock.patch.object(jax_dn, 'hungarian_match', jax_scipy):
            state, _, m = jax.jit(make_train_step(jc, use_gt_depth=True))(
                state, jax_init_state(1, jc.head),
                jax_batch(jc, batch=1, seed=6), key)
        total = float(np.asarray(m['grad_norm']))
        zeros = jax.tree_util.tree_map(
            lambda x: np.zeros_like(np.asarray(x)),
            {'stats': state.stats, 'batch_stats': state.batch_stats})
        mu = from_jax_variables(
            {'params': _jax_first_moments(state), **zeros}, pc)
        per = unclipped_norms({k: v.numpy() / 0.1 for k, v in mu.items()},
                              total, clip)
        return total, per, {k: float(np.asarray(v)) for k, v in m.items()}

    out, t0 = {'size': args.size}, time.perf_counter()
    flax_state, _ = jax_create_state(jc, jax.random.PRNGKey(0), batch=1)
    out['jax_flax_init'] = jax_step({
        'params': flax_state.params, 'stats': flax_state.stats,
        'batch_stats': flax_state.batch_stats})
    del flax_state
    print(f'JAX, flax init: {out["jax_flax_init"][0]:.6g} '
          f'({time.perf_counter() - t0:.0f} s)', flush=True)

    sd = init_state_dict(pc, seed=0)
    converted, missing = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jc, jax_variable_template(jc))
    assert not missing, missing[:5]
    out['jax_init_state_dict'] = jax_step(
        jax.tree_util.tree_map(jnp.asarray, converted))
    print(f'JAX, init_state_dict: {out["jax_init_state_dict"][0]:.6g} '
          f'({time.perf_counter() - t0:.0f} s)', flush=True)

    model = Far3D(pc)
    model.load_state_dict(sd)
    state, tt = create_train_state(pc, model, batch=1)
    with mock.patch.object(port_losses3d, 'hungarian_match', port_scipy), \
            mock.patch.object(port_dn, 'hungarian_match', port_scipy):
        _, _, m = step_from_noise(pc, state, tt,
                                  synthetic_batch(pc, batch=1, seed=6),
                                  jax_step_noise(jc, key, 0))
    total = float(m['grad_norm'])
    out['port_init_state_dict'] = (
        total, unclipped_norms({n: p.grad.numpy() for n, p in
                                model.named_parameters()
                                if p.grad is not None}, total, clip),
        {k: float(v) for k, v in m.items()})
    print(f'port, init_state_dict: {total:.6g} '
          f'({time.perf_counter() - t0:.0f} s)', flush=True)

    report = {'size': args.size}
    for name in ('jax_flax_init', 'jax_init_state_dict',
                 'port_init_state_dict'):
        total, per, losses = out[name]
        top = sorted(per, key=per.get, reverse=True)[:10]
        report[name] = {'grad_norm': total,
                        'top': [[k, per[k]] for k in top],
                        'total_loss': losses['total_loss']}
        print(name)
        for k in top:
            print(f'  {k:75s} {per[k]:.4g}')
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == '__main__':
    main()
