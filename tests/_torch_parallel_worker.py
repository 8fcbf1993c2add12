"""One rank of the port's data-parallel tests (tests/test_torch_port_parallel.py):

    FAR3D_COORDINATOR=file:///tmp/x/store FAR3D_NUM_PROCESSES=2 \\
        FAR3D_PROCESS_ID=0 python tests/_torch_parallel_worker.py <mode> <dir>

It joins the gloo group on the CPU through ``parallel.mesh.init_distributed``
and runs `mode`, reading its inputs from and writing its outputs to <dir>:

* ``sum``: a global sum of 18.0 from rank-local halves (the twin of
  tests/test_multiprocess.py), the rank's lanes of a global batch, and the
  backward of the differentiable all-reduce;
* ``far3d`` / ``petr``: the training steps of ``inputs.pt`` (config, state
  dict, global batch, the steps' global draws) on the rank's lanes; writes
  ``out_<rank>.pt`` (metrics, state dict, Adam first moments, temporal
  state);
* ``eval``: the rank's shard of ``eval.json``'s dataset through
  ``EvalLoader``, ``run_inference`` and ``collect_and_evaluate``;
* ``cli_train``: ``cli.train``'s main on the arguments of ``argv.json``;
* ``resume``: ``train_loop``'s start with no step to run, each rank on its
  own work dir ``ckpt_<rank>`` (the config of ``resume.pt``, initial
  weights seeded by the rank); prints the step and ``state_digest`` of the
  state every rank goes on from, then whether a forced save of that step
  refuses, or that the restore refused.

It imports torch and far3d_tpu_torch, never jax or far3d_tpu.
"""

import dataclasses
import hashlib
import json
import sys
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from far3d_tpu_torch.parallel import mesh  # noqa: E402


def run_sum(work, rank, world):
    local = torch.full((2, 3), float(rank + 1))
    total = mesh.all_reduce_sum_(local.sum())        # (1+1+2+2) * 3
    lanes = mesh.shard_batch({'x': torch.arange(12.0).reshape(4, 3),
                              'meta': 'kept'}, rank, world)
    x = torch.ones(3, requires_grad=True)
    (mesh.all_reduce_sum(x) * (rank + 1)).sum().backward()
    print(f'rank{rank} sum {float(total)} lanes '
          f'{lanes["x"][:, 0].tolist()} {lanes["meta"]} '
          f'grad {x.grad.tolist()} normalizer '
          f'{float(mesh.normalizer(torch.tensor(float(rank))))}', flush=True)


def _outputs(state, tt, metrics):
    opt = state.optimizer
    moments = {}
    for name, p in state.model.named_parameters():
        st = opt.state.get(p, {})
        moments[name] = st['exp_avg'] if 'exp_avg' in st \
            else torch.zeros_like(p)
    return dict(metrics=metrics, state_dict=state.model.state_dict(),
                moments=moments, step=state.step,
                tstate={f.name: getattr(tt, f.name)
                        for f in dataclasses.fields(tt)})


def run_steps(work, rank, world, family):
    inp = torch.load(work / 'inputs.pt', weights_only=False)
    cfg = inp['cfg']
    if family == 'far3d':
        from far3d_tpu_torch.models.detector import Far3D
        from far3d_tpu_torch.train.step import (create_train_state,
                                                step_from_noise)
        model = Far3D(cfg)
        model.load_state_dict(inp['state_dict'])
        state, tt = create_train_state(cfg, model, batch=1)

        def step(state, tt, batch, noise):
            return step_from_noise(cfg, state, tt, batch, noise,
                                   use_gt_depth=inp['use_gt_depth'])
    else:
        from far3d_tpu_torch.models.streampetr import StreamPETR
        from far3d_tpu_torch.train.petr_step import (create_petr_train_state,
                                                     petr_step_from_noise)
        model = StreamPETR(cfg)
        model.load_state_dict(inp['state_dict'])
        state, tt = create_petr_train_state(model, inp['train_cfg'], batch=1)

        def step(state, tt, batch, noise):
            return petr_step_from_noise(cfg, inp['train_cfg'], state, tt,
                                        batch, noise)

    batch = mesh.shard_batch(inp['batch'], rank, world)
    metrics = []
    for s, noise in enumerate(inp['noises']):
        if s:
            batch.update(mesh.shard_batch(inp['next_frame'], rank, world))
        state, tt, m = step(state, tt, batch,
                            mesh.shard_batch(noise, rank, world))
        metrics.append({k: float(v) for k, v in m.items()})
    torch.save(_outputs(state, tt, metrics), work / f'out_{rank}.pt')


def run_eval(work, rank, world):
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.data.av2_dataset import AV2SequenceDataset
    from far3d_tpu_torch.data.loader import EvalLoader
    from far3d_tpu_torch.entry import build_model
    from far3d_tpu_torch.eval.runner import (collect_and_evaluate,
                                             run_inference)
    args = json.loads((work / 'eval.json').read_text())
    cfg = tiny_test_config()
    dataset = AV2SequenceDataset(args['ann'], args['root'], split='val',
                                 seq_split_num=1, test_mode=False)
    model = build_model(cfg, 'cpu', seed=0)
    loader = EvalLoader(dataset, cfg, rank=rank, world_size=world,
                        num_threads=2, device='cpu')
    results = run_inference(cfg, model, loader, device='cpu')
    print('rank%d indices %s' % (rank, ','.join(str(r['index'])
                                                for r in results)),
          flush=True)
    out = collect_and_evaluate(cfg, dataset, args['results_dir'], rank,
                               world, results)
    if rank == 0:
        summary, means = out
        print('rank0 ngts %d mAP %r' % (
            sum(r['num_gts'] for r in summary.values()), means['mAP']),
            flush=True)


def state_digest(state) -> str:
    """sha256 of a train state's step, parameters and buffers, EMA shadow
    and AdamW state, in a fixed order."""
    h = hashlib.sha256(str(state.step).encode())
    opt = state.optimizer
    tensors = list(state.model.state_dict().values())
    tensors += list((state.ema or {}).values())
    tensors += [st[k] for g in opt.param_groups for p in g['params']
                for st in [opt.state.get(p, {})] for k in sorted(st)]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def run_resume(work, rank):
    from far3d_tpu_torch.entry import build_model
    from far3d_tpu_torch.train.runner import train_loop
    from far3d_tpu_torch.train.step import create_train_state
    from far3d_tpu_torch.utils.checkpoint import CheckpointManager
    cfg = torch.load(work / 'resume.pt', weights_only=False)['cfg']
    state, tt = create_train_state(cfg, build_model(cfg, 'cpu',
                                                    seed=10 + rank))
    own = work / f'ckpt_{rank}'
    try:
        # the loop asks an empty loader for its first batch when the start
        # leaves a step to run: the start has then filled `state` in place
        train_loop(state, tt, None, cfg.train, [], str(own),
                   torch.device('cpu'), max_iters=2)
    except StopIteration:
        pass
    except FileNotFoundError as e:
        print(f'rank{rank} restore refused: {e}', flush=True)
        return
    print(f'rank{rank} step {state.step} digest {state_digest(state)}',
          flush=True)
    try:
        CheckpointManager(str(own)).save(state.step, state, force=True)
        print(f'rank{rank} saved step {state.step}', flush=True)
    except FileExistsError:
        print(f'rank{rank} save refused', flush=True)


def main():
    mode, work = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(2)
    rank, world = mesh.init_distributed('cpu',
                                        timeout=timedelta(seconds=180))
    assert mesh.group() is not None and world == 2, (rank, world)
    try:
        if mode == 'sum':
            run_sum(work, rank, world)
        elif mode == 'eval':
            run_eval(work, rank, world)
        elif mode == 'resume':
            run_resume(work, rank)
        elif mode == 'cli_train':
            from far3d_tpu_torch.cli import train
            train.main(json.loads((work / 'argv.json').read_text()))
        else:
            run_steps(work, rank, world, mode)
    finally:
        mesh.shutdown()
    print(f'rank{rank} done', flush=True)


if __name__ == '__main__':
    main()
