"""Training soak at full width (the twin of ``tools/soak.py``), with
synthetic batches, no dataset:

    python -m far3d_tpu_torch.cli.soak --iters 300 --switch-at 150 \\
        --resume-iters 20 --log soak.jsonl --work /tmp/soak [--tiny]
        [--device cpu]

Phase 1, resume is bit-exact, over --resume-iters (N) steps:
  a. two uninterrupted N-step runs from the same weights are bitwise equal
     (the card's determinism, which the JAX tool takes for granted);
  b. N/2 steps, a save with ``CheckpointManager``, a restore into a fresh
     state, N/2 more steps: every parameter, buffer, both Adam moments,
     their step counts and the state's step bitwise equal to run a's.
  At most one train state is on the device at a time; the others are kept
  as CPU copies.
Phase 2, stability: --iters steps across the GT-depth switch at
--switch-at, one JSON line per 10-step window (and at the switch) with
iter, loss, grad_norm, s_per_it and use_gt_depth, to --log; step 0's
gradient norm and the 5 parameters that carry it are printed first.

``Far3DConfig()`` (or the tiny test config) with warmup 20 and the switch
at --switch-at; ``synthetic_batch(cfg, 1, s)`` for s in 0-3, in turn; each
step's DN and dropout generators seeded from the step as ``run_training``
seeds them. The exit code is 1 when a resume check finds a difference or a
window is not finite.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch

WINDOW = 10


def snapshot(state) -> dict:
    """CPU copies of everything phase 1 compares: the model's parameters
    and buffers, both Adam moments and their step counts, and the step."""
    out = {f'model.{k}': v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f'{k}.{name}'] = v.detach().cpu().clone()
    out['step'] = torch.tensor(state.step)
    return out


def differences(a: dict, b: dict) -> list:
    """The names whose tensors are not bitwise equal (or missing)."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not torch.equal(a[k], b[k]))


def grad_carriers(model, total: float, clip: float, n: int = 5):
    """The `n` parameters with the largest gradient norms before the clip,
    read from the clipped gradients the step leaves (scale clip / total)."""
    scale = max(total / clip, 1.0)
    norms = {k: float(p.grad.norm()) * scale
             for k, p in model.named_parameters() if p.grad is not None}
    return sorted(norms.items(), key=lambda kv: -kv[1])[:n]


class Soak:
    def __init__(self, cfg, device):
        from ..utils.synthetic import synthetic_batch
        self.cfg = cfg
        self.device = device
        self.batches = [{k: v.to(device) for k, v in
                         synthetic_batch(cfg, batch=1, seed=s).items()}
                        for s in range(4)]
        self.noise_gen = torch.Generator()
        self.dropout_gen = torch.Generator(device=device)

    def fresh(self, seed: int):
        from ..entry import build_model
        from ..train.step import create_train_state
        from ..utils.convert import init_state_dict
        model = build_model(self.cfg, self.device,
                            weights=init_state_dict(self.cfg, seed))
        return create_train_state(self.cfg, model, batch=1)

    def step(self, state, tstate, i):
        from ..train.runner import step_seed
        from ..train.step import train_step
        tc = self.cfg.train
        self.noise_gen.manual_seed(step_seed(tc.seed, i))
        self.dropout_gen.manual_seed(step_seed(tc.seed, i, 0))
        return train_step(self.cfg, state, tstate, self.batches[i % 4],
                          self.noise_gen, self.dropout_gen,
                          use_gt_depth=i < tc.use_gt_depth_until_iter)

    def run(self, state, tstate, start, count):
        for i in range(start, start + count):
            state, tstate, _ = self.step(state, tstate, i)
        return state


def resume_check(soak: Soak, n: int, work: str) -> dict:
    """Phase 1 -> {'repeat_diffs': [...], 'resume_diffs': [...]}."""
    from ..utils.checkpoint import CheckpointManager
    state, tstate0 = soak.fresh(0)
    ref = snapshot(soak.run(state, tstate0, 0, n))
    del state
    state, _ = soak.fresh(0)
    repeat = differences(ref, snapshot(soak.run(state, tstate0, 0, n)))
    del state
    print(f'[soak] two uninterrupted {n}-step runs: '
          f'{"bitwise equal" if not repeat else f"{len(repeat)} differ"}'
          + (f' {repeat[:8]}' if repeat else ''), flush=True)

    state, _ = soak.fresh(0)
    state = soak.run(state, tstate0, 0, n // 2)
    mgr = CheckpointManager(work, max_to_keep=1, save_interval=1)
    assert mgr.save(n // 2, state, force=True)
    del state
    fresh, _ = soak.fresh(0)
    restored = mgr.restore(fresh)
    assert restored is not None and restored.step == n // 2
    resumed = differences(ref, snapshot(
        soak.run(restored, tstate0, n // 2, n - n // 2)))
    del fresh, restored
    print(f'[soak] {n // 2} steps, save, restore, {n - n // 2} more: '
          f'{"bitwise equal" if not resumed else f"{len(resumed)} differ"}'
          + (f' {resumed[:8]}' if resumed else ''), flush=True)
    return {'repeat_diffs': repeat, 'resume_diffs': resumed,
            'compared': len(ref)}


def stability(soak: Soak, iters: int, log_path: str) -> dict:
    """Phase 2 -> {'windows': [...], 'step0': {...}, 'finite': bool}."""
    cfg = soak.cfg
    state, tstate = soak.fresh(1)
    windows, step0, finite = [], None, True
    t0 = time.perf_counter()
    with open(log_path, 'w') as f:
        for i in range(iters):
            state, tstate, m = soak.step(state, tstate, i)
            use_gt = i < cfg.train.use_gt_depth_until_iter
            if i == 0:
                gn = float(m['grad_norm'])
                step0 = {'grad_norm': gn, 'carriers': grad_carriers(
                    state.model, gn, cfg.train.grad_clip_norm)}
                print('[soak] step 0 grad_norm', json.dumps(step0),
                      flush=True)
            switch = i + 1 == cfg.train.use_gt_depth_until_iter
            if (i + 1) % WINDOW == 0 or switch:
                loss, gn = float(m['total_loss']), float(m['grad_norm'])
                dt = (time.perf_counter() - t0) / WINDOW
                t0 = time.perf_counter()
                rec = {'iter': i + 1, 'loss': loss, 'grad_norm': gn,
                       's_per_it': dt, 'use_gt_depth': use_gt}
                f.write(json.dumps(rec) + '\n')
                f.flush()
                windows.append(rec)
                print('[soak]', json.dumps(rec), flush=True)
                if not (math.isfinite(loss) and math.isfinite(gn)):
                    finite = False
                    print('[soak] NON-FINITE: FAIL', flush=True)
                    break
    return {'windows': windows, 'step0': step0, 'finite': finite}


def build_config(tiny: bool, switch_at: int):
    from ..config import Far3DConfig, tiny_test_config
    cfg = tiny_test_config() if tiny else Far3DConfig()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, use_gt_depth_until_iter=switch_at, warmup_iters=20))


def run_soak(iters=300, switch_at=150, resume_iters=20, log='soak.jsonl',
             work='/tmp/soak_ckpt', tiny=False, device=None) -> dict:
    """Both phases -> {'resume': phase 1, 'stability': phase 2, 'ok'}."""
    from ..entry import resolve_device
    device = resolve_device(device)
    soak = Soak(build_config(tiny, switch_at), device)
    print(f'[soak] phase 1: resume bit-exactness over {resume_iters} '
          f'steps', flush=True)
    resume = resume_check(soak, resume_iters, work)
    ok = not resume['repeat_diffs'] and not resume['resume_diffs']
    print(f'[soak] phase 2: {iters} steps, switch at {switch_at}', flush=True)
    stab = stability(soak, iters, log)
    ok = ok and stab['finite']
    print(f'[soak] {"PASS" if ok else "FAIL"}', flush=True)
    return {'resume': resume, 'stability': stab, 'ok': ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=300)
    ap.add_argument('--switch-at', type=int, default=150)
    ap.add_argument('--resume-iters', type=int, default=20)
    ap.add_argument('--log', default='soak.jsonl')
    ap.add_argument('--work', default='/tmp/soak_ckpt')
    ap.add_argument('--tiny', action='store_true',
                    help='tiny test config (a CPU smoke of this tool)')
    ap.add_argument('--device', default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         'on the CPU)')
    args = ap.parse_args(argv)
    out = run_soak(args.iters, args.switch_at, args.resume_iters, args.log,
                   args.work, args.tiny, args.device)
    return 0 if out['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
