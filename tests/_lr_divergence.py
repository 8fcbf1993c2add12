"""How fast the port's and the JAX package's training parts at the full-size
closed loop's learning rate, on the CPU at the tiny size: both steps from
the same seeded weights (``_torch_port_setup.shared_weights``), f32, no
dropout, no grid mask, lr 1e-3 with a one-step warm-up, the JAX step's DN
draws, the auction on both sides. Prints each step's total loss and grad
norm for both, then the parameters whose difference is largest against how
far they moved.

    JAX_PLATFORMS=cpu python tests/_lr_divergence.py [--steps 4]

Adam's first update moves every element by about lr in the sign of its
gradient, so an element whose gradient is near 0 takes the sign of f32
summation noise, and the two runs part within a few steps: one seed of
either package is one sample of such a loop.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=4)
    args = ap.parse_args()

    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    import numpy as np

    from _torch_port_setup import shared_weights, to_np
    from far3d_tpu.models.farhead import init_state as jax_init_state
    from far3d_tpu.train.optim import make_optimizer as jax_make_optimizer
    from far3d_tpu.train.step import TrainState as JaxTrainState
    from far3d_tpu.train.step import make_train_step
    from far3d_tpu.utils.synthetic import synthetic_batch as jax_batch
    from far3d_tpu_torch.models.detector import Far3D
    from far3d_tpu_torch.train.step import create_train_state, step_from_noise
    from far3d_tpu_torch.utils.convert import from_jax_variables
    from far3d_tpu_torch.utils.synthetic import synthetic_batch
    from test_torch_port_train_step import jax_step_noise, train_cfgs

    def loop_lr(c):
        return c.replace(train=dataclasses.replace(
            c.train, lr=1e-3, warmup_iters=1, use_grid_mask=False))

    jc, pc = map(loop_lr, train_cfgs())
    variables, sd = shared_weights(jc, pc)
    key = jax.random.PRNGKey(1)
    params = variables['params']
    js = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        stats=variables['stats'], batch_stats=variables['batch_stats'],
        opt_state=jax_make_optimizer(jc.train, params).init(params),
        ema_params=None)
    jt, jb = jax_init_state(1, jc.head), jax_batch(jc, batch=1, seed=6)
    jstep = jax.jit(make_train_step(jc, use_gt_depth=True))
    model = Far3D(pc)
    model.load_state_dict(sd)
    st, tt = create_train_state(pc, model, batch=1)
    batch = synthetic_batch(pc, batch=1, seed=6)
    print('step  total_loss JAX / port  grad_norm JAX / port')
    for s in range(args.steps):
        js, jt, m = jstep(js, jt, jb, key)
        st, tt, tm = step_from_noise(pc, st, tt, batch,
                                     jax_step_noise(jc, key, s))
        print(f'{s}  {float(m["total_loss"]):.4f} / '
              f'{float(tm["total_loss"]):.4f}  {float(m["grad_norm"]):.4f} '
              f'/ {float(tm["grad_norm"]):.4f}')
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        'params': js.params, 'stats': js.stats,
        'batch_stats': js.batch_stats}), pc)
    got = st.model.state_dict()
    rows = []
    for k, w in want.items():
        moved = float(np.abs(w.numpy() - sd[k].numpy()).max())
        err = float(np.abs(to_np(got[k]) - w.numpy()).max())
        rows.append((err / max(moved, 1e-12), err, moved, k))
    for r in sorted(rows, reverse=True)[:8]:
        print('difference %.3g of the move (%.3g against %.3g): %s' % r)


if __name__ == '__main__':
    main()
