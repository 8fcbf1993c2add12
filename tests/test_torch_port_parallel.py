"""Data parallelism of the port (far3d_tpu_torch/parallel/mesh.py and what
runs through it) over two real processes on the CPU: gloo, a ``file://``
store under the test's temporary directory, each rank a subprocess of
``tests/_torch_parallel_worker.py`` (torch and far3d_tpu_torch only) with its
own timeout; a rank that fails stops the other.

* ``init_distributed`` from the ``FAR3D_*`` variables and a global sum of
  18.0 from rank-local halves (the twin of tests/test_multiprocess.py:18-86),
  the rank's lanes of a global batch, the differentiable all-reduce's
  backward; no group without a launch, and no quiet CPU fallback;
* two ranks at batch 1 against the JAX package's ``make_train_step`` at
  batch 2 on the same weights (the twin of tests/test_train_step.py:41-83
  across frameworks): tiny, f32, dropout 0, the auction on both sides, the
  JAX step's batch-2 draws cut by lane. Losses, grad norm, Adam's first moments, the
  updated parameters and YOLOX BN statistics at ``TOL`` (rtol 1e-3 / atol
  2e-3), the temporal state lane by lane, the ranks' parameters bitwise
  equal. Two batches: the synthetic one (5 and 3 GT boxes in the lanes),
  and one whose second lane holds no box at all, so that the ranks'
  normalizers differ as far as they can;
* the same for StreamPETR against ``make_petr_train_step`` (the twin of
  tests/test_petr_train.py:71-86);
* multi-process evaluation, the twin of tests/test_multiprocess.py:88-196:
  9 frames over 2 ranks, rank 0 indices 0-4 and rank 1 indices 5-8 (the pad
  dropped), the parts in rank order, rank 0 scoring the union of the GT;
  rank 0's frames bitwise those of one process;
* ``cli.train`` on two ranks: rank 0 alone writes the metrics, the
  evaluation during training and whole checkpoints; a second launch
  resumes on both ranks;
* the start of ``train_loop`` when the ranks' disks disagree: every rank
  goes on from rank 0's whole state, and when one rank cannot see the
  checkpoint that rank 0 resumes from, every rank refuses.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far3d_tpu.config as jcfg
import far3d_tpu.models.streampetr as jsp
import far3d_tpu_torch.config as tcfg
import far3d_tpu_torch.models.streampetr as tsp
from _torch_parallel_worker import state_digest
from _torch_port_setup import TOL, shared_weights, to_np
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.train.optim import make_optimizer as jax_make_optimizer
from far3d_tpu.train.petr_step import make_petr_train_step
from far3d_tpu.train.step import TrainState as JaxTrainState
from far3d_tpu.train.step import make_train_step
from far3d_tpu.utils.synthetic import synthetic_batch as jax_synthetic_batch
from far3d_tpu_torch.data.av2_dataset import AV2SequenceDataset
from far3d_tpu_torch.data.image_io import write_png
from far3d_tpu_torch.data.loader import EvalLoader
from far3d_tpu_torch.entry import build_model
from far3d_tpu_torch.eval.runner import run_inference
from far3d_tpu_torch.parallel import mesh
from far3d_tpu_torch.train.step import create_train_state
from far3d_tpu_torch.utils.checkpoint import CheckpointManager
from far3d_tpu_torch.utils.convert import (from_jax_variables,
                                           petr_from_jax_variables)
from far3d_tpu_torch.utils.synthetic import (petr_synthetic_batch,
                                             synthetic_batch)
from test_data import make_fake_infos
from test_torch_port_petr import (_assert_moments, _moments, _petr_shim,
                                  jax_petr_noise, petr_frame, random_leaves)
from test_torch_port_train_step import _jax_first_moments, train_cfgs

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / 'tests' / '_torch_parallel_worker.py'
WORLD = 2
RANK_TIMEOUT_S = 240
STEPS = 2
RNG_SEED = 1          # the grid mask applies at both steps with this key
PETR_RNG_SEED = 3
NEXT_FRAME = dict(prev_exists=np.ones((WORLD,), np.float32),
                  timestamp=np.full((WORLD,), 0.5, np.float32))
TSTATE_FIELDS = ('embedding', 'ref_points', 'timestamp', 'egopose', 'velo')


def spawn_ranks(mode, work: Path, world=WORLD):
    """Run `world` ranks of the worker in `mode` on `work`; returns their
    outputs. A rank that fails, or the timeout, kills the others."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT', 'SLURM_NTASKS')}
    env.update(FAR3D_COORDINATOR=f'file://{work}/store',
               FAR3D_NUM_PROCESSES=str(world), OMP_NUM_THREADS='2')
    logs = [work / f'rank{r}.log' for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], 'w') as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), mode, str(work)],
                env={**env, 'FAR3D_PROCESS_ID': str(r)}, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [log.read_text() for log in logs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank{r} failed ({p.returncode}):\n{out}'
        assert f'rank{r} done' in out, out
    return outs


# ---------------------------------------------------------------- the group

def test_two_ranks_global_sum(tmp_path):
    outs = spawn_ranks('sum', tmp_path)
    for r, out in enumerate(outs):
        # (1+1+2+2) * 3; lanes 0-1 and 2-3 of the global 4; the backward
        # sums every rank's output gradient (1 + 2); max(0 + 1, 1) / 2
        lanes = '[0.0, 3.0]' if r == 0 else '[6.0, 9.0]'
        assert (f'rank{r} sum 18.0 lanes {lanes} kept grad [3.0, 3.0, 3.0] '
                'normalizer 0.5') in out, out


def test_no_launch_builds_no_group(monkeypatch):
    for k in ('FAR3D_COORDINATOR', 'RANK', 'WORLD_SIZE', 'SLURM_NTASKS'):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed('cpu') == (0, 1)
    assert mesh.group() is None and mesh.rank_and_world() == (0, 1)
    assert mesh.is_main()
    x = torch.arange(4.0)
    assert mesh.all_reduce_sum(x) is x
    assert torch.equal(mesh.normalizer(torch.tensor(0.25)), torch.tensor(1.0))
    assert mesh.shard_batch({'x': x}, 0, 1)['x'] is x
    assert mesh.all_reduce_mean_([x]) == 0


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('FAR3D_COORDINATOR', 'file:///nonexistent/store')
    monkeypatch.setenv('FAR3D_NUM_PROCESSES', '2')
    monkeypatch.setenv('FAR3D_PROCESS_ID', '0')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mesh.init_distributed('cpu', backend='nccl')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mesh.init_distributed()
    assert mesh.group() is None


def test_shard_batch_refuses_uneven_lanes():
    with pytest.raises(ValueError, match='does not split'):
        mesh.shard_batch(torch.zeros(3, 2), 0, 2)


# ------------------------------------------------ Far3D: DP == JAX batch 2

def jax_step_noise(cfg, key, step, batch):
    """The grid-mask and DN draws of the JAX step number `step` at `batch`
    lanes (step.py:98-99, grid_mask.py:20-25, dn.py:57-70)."""
    rng_gm, rng_dn, _ = jax.random.split(jax.random.fold_in(key, step), 3)
    k_apply, k_d, k_sh, k_sw = jax.random.split(rng_gm, 4)
    d = int(jax.random.randint(k_d, (), 2, cfg.data.input_hw[0]))
    grid = dict(
        apply=bool(jax.random.uniform(k_apply) < cfg.train.grid_mask_prob),
        d=d, st_h=int(jax.random.randint(k_sh, (), 0, d)),
        st_w=int(jax.random.randint(k_sw, (), 0, d)))
    c = cfg.head
    kp, kps, kn, kns = jax.random.split(rng_dn, 4)
    shape_p = (batch, c.dn_groups, c.dn_max_gt, 3)
    shape_n = (batch, c.dn_groups, c.num_smp_per_gt - 1, c.dn_max_gt, 3)

    def sign(k, shape):
        return jax.random.randint(k, shape, 0, 2).astype(jnp.float32) * 2 - 1

    dn = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        rand_p=jax.random.uniform(kp, shape_p), sign_p=sign(kps, shape_p),
        rand_n=jax.random.uniform(kn, shape_n), sign_n=sign(kns, shape_n)
    ).items()}
    return dict(grid_mask=grid, dn=dn)


_JAX_STEPS = {}


def _jax_step(name, make):
    """One compiled JAX step per family, shared by the batches."""
    if name not in _JAX_STEPS:
        _JAX_STEPS[name] = jax.jit(make())
    return _JAX_STEPS[name]


def _empty_second_lane(jbatch, pbatch, keys):
    """Lane 1 holds no GT: rank 1's local normalizers are 0."""
    out = {}
    for k in keys:
        m = np.asarray(getattr(jbatch, k)).copy()
        m[1] = False
        out[k] = m
        pbatch[k] = torch.from_numpy(m)
    return jbatch.replace(**{k: jnp.asarray(v) for k, v in out.items()})


def _run_ranks(work, inputs):
    torch.save(inputs, work / 'inputs.pt')
    spawn_ranks(inputs['family'], work)
    return [torch.load(work / f'out_{r}.pt', weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope='module', params=['uneven_gt', 'empty_lane'])
def far3d_dp(request, tmp_path_factory):
    jax_cfg, port_cfg = train_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg)
    key = jax.random.PRNGKey(RNG_SEED)
    jbatch = jax_synthetic_batch(jax_cfg, batch=WORLD, seed=6)
    pbatch = synthetic_batch(port_cfg, batch=WORLD, seed=6)
    if request.param == 'empty_lane':
        jbatch = _empty_second_lane(jbatch, pbatch, ('gt_mask', 'gt_mask2d'))
    counts = np.asarray(jbatch.gt_mask).sum(1)
    assert counts[0] != counts[1], counts

    params = variables['params']
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        stats=variables['stats'], batch_stats=variables['batch_stats'],
        opt_state=jax_make_optimizer(jax_cfg.train, params).init(params),
        ema_params=None)
    jt = jax_init_state(WORLD, jax_cfg.head)
    jmetrics = []
    step = _jax_step('far3d', lambda: make_train_step(
        jax_cfg, use_gt_depth=True))
    for s in range(STEPS):
        b = jbatch if s == 0 else jbatch.replace(**NEXT_FRAME)
        jstate, jt, m = step(jstate, jt, b, key)
        jmetrics.append({k: float(np.asarray(v)) for k, v in m.items()})

    outs = _run_ranks(tmp_path_factory.mktemp('far3d_dp'), dict(
        family='far3d', cfg=port_cfg, state_dict=sd, batch=pbatch,
        noises=[jax_step_noise(jax_cfg, key, s, WORLD) for s in range(STEPS)],
        next_frame={k: torch.from_numpy(v) for k, v in NEXT_FRAME.items()},
        use_gt_depth=True))
    return dict(jax=(jstate, jt, jmetrics), ranks=outs, cfg=port_cfg)


def _assert_ranks_equal(outs):
    """The ranks' parameters, buffers and moments bitwise equal, their
    logged metrics (group means) too."""
    a, b = outs
    assert a['step'] == b['step'] == STEPS
    for k in a['state_dict']:
        assert torch.equal(a['state_dict'][k], b['state_dict'][k]), k
    for k in a['moments']:
        assert torch.equal(a['moments'][k], b['moments'][k]), k
    assert a['metrics'] == b['metrics']


def test_far3d_dp_ranks_stay_equal(far3d_dp):
    _assert_ranks_equal(far3d_dp['ranks'])


@pytest.mark.parametrize('step', range(STEPS))
def test_far3d_dp_losses_and_grad_norm_match_jax(far3d_dp, step):
    want = far3d_dp['jax'][2][step]
    got = far3d_dp['ranks'][0]['metrics'][step]
    assert got.keys() == want.keys()
    assert want['total_loss'] > 0
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_far3d_dp_parameters_and_bn_stats_match_jax(far3d_dp):
    jstate = far3d_dp['jax'][0]
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        'params': jstate.params, 'stats': jstate.stats,
        'batch_stats': jstate.batch_stats}), far3d_dp['cfg'])
    got = far3d_dp['ranks'][0]['state_dict']
    assert got.keys() == want.keys()
    bn = [k for k in want if 'bn.running_' in k]
    assert bn
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), want[k].numpy(), err_msg=k,
                                   **TOL)


def test_far3d_dp_adam_moments_match_jax(far3d_dp):
    """Adam's first moments hold both steps' clipped, averaged gradients
    (rtol 1e-3, atol 2e-3 of the tensor's largest moment, as
    tests/test_torch_port_train_step.py holds one process)."""
    jstate = far3d_dp['jax'][0]
    zeros = jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   {'stats': jstate.stats,
                                    'batch_stats': jstate.batch_stats})
    want = from_jax_variables({'params': _jax_first_moments(jstate), **zeros},
                              far3d_dp['cfg'])
    got = far3d_dp['ranks'][0]['moments']
    moved = 0
    for k, g in got.items():
        w = want[k].numpy()
        scale = float(np.abs(w).max())
        moved += scale > 0
        np.testing.assert_allclose(to_np(g), w, rtol=1e-3,
                                   atol=max(2e-3 * scale, 1e-12), err_msg=k)
    assert moved > 0.8 * len(got)


def test_far3d_dp_temporal_state_per_lane(far3d_dp):
    jt = far3d_dp['jax'][1]
    for r, out in enumerate(far3d_dp['ranks']):
        for field in TSTATE_FIELDS:
            np.testing.assert_allclose(
                to_np(out['tstate'][field]),
                np.asarray(getattr(jt, field))[r:r + 1],
                err_msg=f'rank {r} {field}', **TOL)


# -------------------------------------------- StreamPETR: DP == JAX batch 2

@pytest.fixture(scope='module')
def petr_dp(tmp_path_factory):
    jc, tc = jsp.tiny_petr_config(), tsp.tiny_petr_config()
    f0 = {k: jnp.asarray(v) for k, v in petr_frame(jc, 0).items()}
    shapes = jax.eval_shape(lambda: jsp.StreamPETR(jc).init(
        jax.random.PRNGKey(0), state=jsp.init_petr_state(1, jc), **f0))
    variables = random_leaves(shapes, 0)
    jc = dataclasses.replace(jc, dropout=0.0)
    tc = dataclasses.replace(tc, dropout=0.0)
    jtrain = dataclasses.replace(jcfg.TrainConfig(), lr=2e-3, warmup_iters=1,
                                 dtype='float32', ema_decay=0.0)
    ttrain = tcfg.TrainConfig(**dataclasses.asdict(jtrain))
    key = jax.random.PRNGKey(PETR_RNG_SEED)

    params = variables['params']
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        stats=variables['stats'], batch_stats={},
        opt_state=jax_make_optimizer(jtrain, params).init(params),
        ema_params=None)
    jt = jsp.init_petr_state(WORLD, jc)
    jbatch = jax_synthetic_batch(_petr_shim(jc), batch=WORLD, seed=6)
    pbatch = petr_synthetic_batch(tc, batch=WORLD, seed=6)
    for k, v in pbatch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jbatch, k)),
                                      err_msg=k)
    counts = np.asarray(jbatch.gt_mask).sum(1)
    assert counts[0] != counts[1], counts
    jmetrics = []
    step = _jax_step('petr', lambda: make_petr_train_step(jc, jtrain))
    for s in range(STEPS):
        b = jbatch if s == 0 else jbatch.replace(**NEXT_FRAME)
        jstate, jt, m = step(jstate, jt, b, key)
        jmetrics.append({k: float(np.asarray(v)) for k, v in m.items()})

    noises = [jax_petr_noise(jc, jtrain, key, s) for s in range(STEPS)]
    assert all(n['grid_mask']['apply'] for n in noises)
    outs = _run_ranks(tmp_path_factory.mktemp('petr_dp'), dict(
        family='petr', cfg=tc, train_cfg=ttrain,
        state_dict=petr_from_jax_variables(variables, tc), batch=pbatch,
        noises=noises,
        next_frame={k: torch.from_numpy(v) for k, v in NEXT_FRAME.items()}))
    return dict(jax=(jstate, jt, jmetrics), ranks=outs, cfg=tc)


def test_petr_dp_ranks_stay_equal(petr_dp):
    _assert_ranks_equal(petr_dp['ranks'])


@pytest.mark.parametrize('step', range(STEPS))
def test_petr_dp_losses_and_grad_norm_match_jax(petr_dp, step):
    want = petr_dp['jax'][2][step]
    got = petr_dp['ranks'][0]['metrics'][step]
    assert got.keys() == want.keys()
    assert want['total_loss'] > 0 and want['loss_bbox'] > 0
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_petr_dp_parameters_and_moments_match_jax(petr_dp):
    jstate = petr_dp['jax'][0]
    want = petr_from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        'params': jstate.params, 'stats': jstate.stats}), petr_dp['cfg'])
    out = petr_dp['ranks'][0]
    assert out['state_dict'].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(to_np(out['state_dict'][k]),
                                   want[k].numpy(), err_msg=k, **TOL)
    mu = _moments(('main', 'backbone'), jstate.opt_state[1].inner_states,
                  jstate.params)
    zeros = jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   jstate.stats)
    moved = _assert_moments(out['moments'], petr_from_jax_variables(
        {'params': mu, 'stats': zeros}, petr_dp['cfg']))
    assert moved > 0.8 * len(out['moments'])


def test_petr_dp_temporal_state_per_lane(petr_dp):
    jt = petr_dp['jax'][1]
    for r, out in enumerate(petr_dp['ranks']):
        for field in TSTATE_FIELDS:
            np.testing.assert_allclose(
                to_np(out['tstate'][field]),
                np.asarray(getattr(jt, field))[r:r + 1],
                err_msg=f'rank {r} {field}', **TOL)


# ------------------------------------------------ multi-process evaluation

def png_dataset(root: Path, n_scenes, frames_per_scene):
    """make_fake_infos with its 2 cameras as random 128x192 PNG files
    written by the port's writer; returns the info file."""
    root.mkdir()
    ann = root / 'infos.pkl'
    make_fake_infos(ann, n_scenes=n_scenes, frames_per_scene=frames_per_scene,
                    n_cams=2)
    with open(ann, 'rb') as f:
        infos = pickle.load(f)['infos']
    rng = np.random.RandomState(0)
    for info in infos:
        for cam in info['cam_infos'].values():
            cam['fpath'] = cam['fpath'].replace('.jpg', '.png')
            path = root / cam['fpath']
            path.parent.mkdir(parents=True, exist_ok=True)
            write_png(str(path), (rng.rand(128, 192, 3) * 255).astype(np.uint8))
    with open(ann, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    return ann


def test_two_rank_eval_collection(tmp_path):
    """collect_results_cpu's semantics (core/apis/test.py:116-160) over two
    real processes, as tests/test_multiprocess.py holds the JAX package."""
    root = tmp_path / 'av2'
    # 9 frames over 2 ranks -> 5 each, rank 1 carrying one padded repeat
    ann = png_dataset(root, n_scenes=3, frames_per_scene=3)
    results_dir = tmp_path / 'results'
    (tmp_path / 'eval.json').write_text(json.dumps(dict(
        ann=str(ann), root=str(root), results_dir=str(results_dir))))
    outs = spawn_ranks('eval', tmp_path)

    assert 'rank0 indices 0,1,2,3,4' in outs[0], outs[0]
    assert 'rank1 indices 5,6,7,8' in outs[1], outs[1]
    parts = []
    for r in range(WORLD):
        with open(results_dir / f'part_{r}.pkl', 'rb') as f:
            parts.extend(pickle.load(f))
    assert [p['index'] for p in parts] == list(range(9))
    assert not list(results_dir.glob('.part_*'))   # renamed whole

    cfg = tcfg.tiny_test_config()
    dataset = AV2SequenceDataset(str(ann), str(root), split='val',
                                 seq_split_num=1, test_mode=False)
    want_gts = sum(len(dataset.get_frame(i)['gt_boxes_3d'])
                   for i in range(9))
    assert f'rank0 ngts {want_gts} mAP' in outs[0], outs[0]
    # rank 0 streams frames 0-4 from a fresh memory, as one process does
    # (at the ranks' thread count: the CPU's sums follow it)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = run_inference(cfg, build_model(cfg, 'cpu', seed=0),
                               EvalLoader(dataset, cfg, num_threads=2,
                                          device='cpu'), device='cpu')
    finally:
        torch.set_num_threads(threads)
    for got, want in zip(parts[:5], single[:5]):
        assert got['index'] == want['index']
        for k in ('boxes', 'scores', 'labels'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_rank_cli_train_writes_once_and_resumes(tmp_path):
    """cli.train on two gloo ranks (the twin of tools/train.py under
    dist_train.sh): rank 0 alone writes metrics.jsonl, the evaluation
    during training and the checkpoints, each whole; a second launch
    resumes from the last checkpoint on both ranks."""
    ann = png_dataset(tmp_path / 'av2', n_scenes=2, frames_per_scene=4)
    work = tmp_path / 'work'
    argv = ['--data-root', str(tmp_path / 'av2'), '--ann-file', str(ann),
            '--val-ann-file', str(ann), '--work-dir', str(work), '--tiny',
            '--device', 'cpu', '--set', 'train.checkpoint_every=2',
            '--set', 'train.log_every=1', '--max-iters', '3']
    for steps in (3, 4):
        argv[-1] = str(steps)
        (tmp_path / 'argv.json').write_text(json.dumps(argv))
        spawn_ranks('cli_train', tmp_path)
        with open(work / 'metrics.jsonl') as f:
            lines = [json.loads(line) for line in f]
        assert [m['iter'] for m in lines] == list(range(1, steps + 1))
        assert all(np.isfinite(m['total_loss']) for m in lines)
        assert sorted(p.name for p in work.glob('*.pt')) == [f'{steps}.pt']
        assert not list(work.glob('.*.tmp'))
    with open(work / 'eval_metrics.jsonl') as f:
        assert [json.loads(line)['step'] for line in f] == [2, 4]
    assert torch.load(work / '4.pt', weights_only=True)['step'] == 4


# ------------------------------------------------- resume across the ranks

def _saved_state(cfg, seed, directory):
    """A tiny train state after one AdamW update, with an EMA shadow, saved
    as step 2 in `directory` (no group); returns it."""
    state, _ = create_train_state(cfg, build_model(cfg, 'cpu', seed=seed))
    gen = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        if p.requires_grad:
            p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()
    for v in state.ema.values():
        v.add_(1.0)
    state.step = 2
    CheckpointManager(str(directory)).save(2, state)
    return state


@pytest.mark.parametrize('disks', ['none', 'differ', 'rank0_only'])
def test_ranks_resume_from_rank0s_state(disks, tmp_path):
    """Each rank reads its own work dir: with no checkpoint, or with files
    of one step that differ, every rank goes on from rank 0's whole state
    (its initial weights, or its file) and a forced save of a step on disk
    refuses on every rank; when only rank 0 sees the checkpoint, every rank
    refuses to resume, and none waits on the others."""
    cfg = tcfg.tiny_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, ema_decay=0.99))
    torch.save({'cfg': cfg}, tmp_path / 'resume.pt')
    if disks == 'none':
        want, _ = create_train_state(cfg, build_model(cfg, 'cpu', seed=10))
    else:
        want = _saved_state(cfg, 20, tmp_path / 'ckpt_0')
    if disks == 'differ':
        _saved_state(cfg, 21, tmp_path / 'ckpt_1')
    outs = spawn_ranks('resume', tmp_path)
    for r, out in enumerate(outs):
        if disks == 'rank0_only':
            assert (f'rank{r} restore refused: 1 of 2 ranks cannot see step '
                    '2') in out, out
            continue
        assert f'rank{r} step {want.step} digest {state_digest(want)}' in out
        assert (f'rank{r} save refused' if disks == 'differ'
                else f'rank{r} saved step 0') in out, out
