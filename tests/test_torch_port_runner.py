"""The port's training loop, checkpoints and streaming evaluation against
the JAX package's, on the CPU at the tiny size.

* ``utils/checkpoint.py``: the same ``save`` calls keep the same steps as
  the JAX package's orbax manager; a restore is bitwise; a restored state's
  next step is bitwise the live state's next step.
* ``train/runner.py``: 3 steps from a PNG dataset on disk with GT depth for
  step 0 only; ``metrics.jsonl`` has the JAX runner's keys (plus the
  reference's ``time`` and ``data_time``); the last step is saved though it
  is off the save interval; ``resume`` goes on from it.
* ``eval/runner.py``: ``run_inference`` and ``collect_and_evaluate`` against
  the JAX package's on shared weights over a two-scene stream, both fed the
  same loader frames normalized to f32: every frame's boxes and scores at
  rtol 1e-3 / atol 2e-3 and the labels equal; scored against GT placed near
  the JAX detections, the same APs and GT counts, the errors and means at
  rtol 1e-3 / atol 2e-3. The
  uint8 branch's normalized bf16 input is bitwise the JAX model's.
* ``utils/convert.py:init_state_dict`` draws from the JAX model's
  initializers; ``config.apply_overrides`` is the JAX package's.
"""

import dataclasses
import json
import pickle

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far3d_tpu.config as jcfg
import far3d_tpu_torch.config as tcfg
from _torch_port_setup import TOL, make_cfgs, port_model, shared_weights
from far3d_tpu.data.av2_dataset import AV2SequenceDataset as JaxDataset
from far3d_tpu.eval import runner as jax_eval
from far3d_tpu.models.detector import Far3D as JaxFar3D
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.models.vovnet import VoVNet as JaxVoVNet
from far3d_tpu.train.step import create_train_state as jax_train_state
from far3d_tpu.train.step import make_train_step
from far3d_tpu.utils.checkpoint import CheckpointManager as JaxCheckpoints
from far3d_tpu.utils.synthetic import synthetic_batch as jax_synthetic_batch
from far3d_tpu_torch.data.av2_dataset import AV2SequenceDataset
from far3d_tpu_torch.data.image_io import write_png
from far3d_tpu_torch.data.loader import EvalLoader, TrainLoader
from far3d_tpu_torch.entry import build_model
from far3d_tpu_torch.eval import runner as port_eval
from far3d_tpu_torch.models.farhead import init_state as port_init_state
from far3d_tpu_torch.train import runner
from far3d_tpu_torch.train.step import create_train_state, train_step
from far3d_tpu_torch.utils.checkpoint import CheckpointManager
from far3d_tpu_torch.utils.convert import from_jax_variables, init_state_dict
from far3d_tpu_torch.utils.synthetic import synthetic_batch
from test_data import make_fake_infos


def tiny_state(seed=0):
    cfg = tcfg.tiny_test_config()
    model = build_model(cfg, 'cpu', weights=init_state_dict(cfg, seed))
    return cfg, *create_train_state(cfg, model)


def runner_step(cfg, state, tstate, batch, use_gt_depth=True):
    """One step as run_training takes it (its per-step seeding)."""
    seed = runner.step_seed(cfg.train.seed, state.step)
    return train_step(cfg, state, tstate, batch,
                      torch.Generator().manual_seed(seed),
                      torch.Generator().manual_seed(seed), use_gt_depth)


def assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa['state'].keys() == ob['state'].keys() and oa['state']
    for i in oa['state']:
        for k in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(oa['state'][i][k], ob['state'][i][k]), (i, k)


# -------------------------------------------------------------- checkpoints
SAVE_SEQUENCES = {
    'interval_4_keep_1': (1, 4, [(s, False) for s in range(1, 7)] + [(6, True)]),
    'interval_3_keep_2': (2, 3, [(s, False) for s in range(1, 8)] + [(8, True)]),
    'interval_1_keep_3': (3, 1, [(s, False) for s in (2, 3, 3, 5, 4, 9)]
                          + [(11, True)]),
}


@pytest.mark.parametrize('name', sorted(SAVE_SEQUENCES))
def test_checkpoint_policy_matches_orbax(tmp_path, name):
    keep, interval, calls = SAVE_SEQUENCES[name]
    _, state, _ = tiny_state()
    jax_tree = {'w': jnp.zeros((3,))}
    jm = JaxCheckpoints(str(tmp_path / 'jax'), keep, interval)
    tm = CheckpointManager(str(tmp_path / 'port'), keep, interval)
    for step, force in calls:
        jm.save(step, jax_tree, force=force)
        tm.save(step, state, force=force)
        assert tm.all_steps() == sorted(jm._mgr.all_steps()), (step, force)
        assert tm.latest_step() == jm.latest_step()
    # a new manager on the same directory goes on from what is there
    jm.close()
    jm = JaxCheckpoints(str(tmp_path / 'jax'), keep, interval)
    tm = CheckpointManager(str(tmp_path / 'port'), keep, interval)
    last = calls[-1][0]
    for step in range(last - 1, last + 2 * interval + 1):
        jm.save(step, jax_tree)
        tm.save(step, state)
        assert tm.all_steps() == sorted(jm._mgr.all_steps()), step
    with pytest.raises(Exception):
        jm.save(jm.latest_step(), jax_tree, force=True)
    with pytest.raises(FileExistsError):
        tm.save(tm.latest_step(), state, force=True)
    jm.close()


@pytest.fixture(scope='module')
def two_steps():
    """A tiny state after two runner steps, and the batch of a third."""
    cfg, state, tstate = tiny_state()
    batch = synthetic_batch(cfg, 1, seed=4)
    for use_gt in (True, False):
        state, tstate, _ = runner_step(cfg, state, tstate, batch, use_gt)
    return cfg, state, tstate, batch


def test_checkpoint_restore_is_bitwise(two_steps, tmp_path):
    cfg, state, _, _ = two_steps
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1, save_interval=1)
    assert mgr.save(state.step, state)
    assert not (tmp_path / f'.{state.step}.pt.tmp').exists()
    _, fresh, _ = tiny_state(seed=1)
    assert mgr.restore(fresh) is fresh
    assert_states_equal(fresh, state)


def test_resumed_step_equals_uninterrupted_step(two_steps, tmp_path):
    cfg, state, tstate, batch = two_steps
    CheckpointManager(str(tmp_path)).save(state.step, state)
    _, resumed, _ = tiny_state(seed=1)
    CheckpointManager(str(tmp_path)).restore(resumed)
    clone = lambda t: dataclasses.replace(
        t, **{f.name: getattr(t, f.name).clone()
              for f in dataclasses.fields(t)})
    _, _, m_live = runner_step(cfg, state, clone(tstate), batch, False)
    _, _, m_resumed = runner_step(cfg, resumed, clone(tstate), batch, False)
    assert m_live.keys() == m_resumed.keys()
    for k in m_live:
        assert torch.equal(m_live[k], m_resumed[k]), k
    assert_states_equal(resumed, state)


# -------------------------------------------------------------------- runner
@pytest.fixture(scope='module')
def png_dataset(tmp_path_factory):
    """make_fake_infos (2 scenes x 3 frames x 2 cameras) as PNG files."""
    root = tmp_path_factory.mktemp('av2png')
    p = root / 'infos.pkl'
    make_fake_infos(p, n_scenes=2, frames_per_scene=3, n_cams=2)
    with open(p, 'rb') as f:
        infos = pickle.load(f)['infos']
    rng = np.random.RandomState(0)
    for info in infos:
        for cam in info['cam_infos'].values():
            cam['fpath'] = cam['fpath'].replace('.jpg', '.png')
            path = root / cam['fpath']
            path.parent.mkdir(parents=True, exist_ok=True)
            write_png(str(path), rng.randint(0, 256, (128, 192, 3)
                                             ).astype(np.uint8))
    with open(p, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    return str(p), str(root)


def jax_metric_keys():
    """The keys of the JAX train step's metrics, from its traced shapes."""
    cfg = jcfg.tiny_test_config()
    key = jax.random.PRNGKey(0)
    state, tstate = jax.eval_shape(lambda k: jax_train_state(cfg, k, 1), key)
    metrics = jax.eval_shape(make_train_step(cfg, use_gt_depth=False), state,
                             tstate, jax_synthetic_batch(cfg, 1), key)[2]
    return set(metrics)


def test_run_training_switch_log_save_resume(png_dataset, tmp_path,
                                             monkeypatch):
    ann, root = png_dataset
    cfg = tcfg.tiny_test_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, use_gt_depth_until_iter=1, checkpoint_every=2,
        log_every=1))
    seen = []

    def recording_step(cfg, state, *args, use_gt_depth):
        seen.append((state.step, use_gt_depth))
        return train_step(cfg, state, *args, use_gt_depth=use_gt_depth)

    monkeypatch.setattr(runner, 'train_step', recording_step)
    evals = []
    loader = TrainLoader(AV2SequenceDataset(ann, root), cfg, 1,
                         num_threads=2, device='cpu')
    try:
        state = runner.run_training(
            cfg, loader, str(tmp_path), 1, resume=False, max_iters=3,
            eval_fn=lambda s: evals.append(s.step), device='cpu')
        assert seen == [(0, True), (1, False), (2, False)]
        assert state.step == 3 and evals == [2]
        lines = [json.loads(x) for x in
                 (tmp_path / 'metrics.jsonl').read_text().splitlines()]
        assert [m['iter'] for m in lines] == [1, 2, 3]
        want = {'iter', 'time', 'data_time'} | jax_metric_keys()
        for m in lines:
            assert set(m) == want
            assert all(np.isfinite(v) for v in m.values())
        # steps 1 (the first save) and 2 (the interval) were saved; 3 is off
        # the interval and saved by force; keep_checkpoints = 1
        assert CheckpointManager(str(tmp_path)).all_steps() == [3]
        seen.clear()
        state = runner.run_training(cfg, loader, str(tmp_path), 1,
                                    resume=True, max_iters=5, device='cpu')
        assert seen == [(3, False), (4, False)] and state.step == 5
        assert CheckpointManager(str(tmp_path)).all_steps() == [5]
    finally:
        loader.stop()


# ---------------------------------------------------------------------- eval
class _Frames:
    """A fixed list of loader frames with EvalLoader's ``pad``."""

    def __init__(self, frames):
        self.frames, self.pad = frames, 0

    def __iter__(self):
        return iter(self.frames)

    def __len__(self):
        return len(self.frames)


@pytest.fixture(scope='module')
def eval_runs(png_dataset, tmp_path_factory):
    ann, root = png_dataset
    jax_cfg, port_cfg = make_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg)
    kw = dict(split='val', seq_split_num=1)
    dataset = AV2SequenceDataset(ann, root, **kw)
    mean = torch.tensor(port_cfg.data.img_mean)
    std = torch.tensor(port_cfg.data.img_std)
    frames = []
    for f in EvalLoader(dataset, port_cfg, num_threads=2, device='cpu'):
        f['images'] = (f['images'].float() - mean) / std
        frames.append(f)
    assert [float(f['prev_exists']) for f in frames] == [0, 1, 1, 0, 1, 1]
    jframes = [{k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in f.items()} for f in frames]
    out = tmp_path_factory.mktemp('results')
    got = port_eval.run_inference(port_cfg, port_model(port_cfg, sd),
                                  _Frames(frames), device='cpu')
    want = jax_eval.run_inference(jax_cfg, variables, _Frames(jframes))
    # score both against GT placed near the detections, so that the
    # metrics are not all zero: every other JAX detection, moved 0.7 m
    with open(ann, 'rb') as f:
        infos = pickle.load(f)['infos']
    for info, det in zip(infos, want):
        boxes = det['boxes'][::2].copy()
        boxes[:, 0] += 0.7
        info['gt3d_infos'] = dict(
            gt_boxes=boxes.astype(np.float32),
            gt_names=np.array([tcfg.AV2_CLASS_NAMES[i]
                               for i in det['labels'][::2]]),
            num_interior_pts=np.ones(len(boxes), np.int64))
    scored = str(out / 'scored.pkl')
    with open(scored, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    got_m = port_eval.collect_and_evaluate(
        port_cfg, AV2SequenceDataset(scored, root, **kw), str(out / 'p'), 0,
        1, got)
    want_m = jax_eval.collect_and_evaluate(
        jax_cfg, JaxDataset(scored, root, **kw), str(out / 'j'), 0, 1, want)
    return got, want, got_m, want_m


def test_run_inference_matches_jax(eval_runs):
    got, want = eval_runs[:2]
    assert len(got) == len(want) == 6
    assert sum(len(w['scores']) for w in want) > 0
    for g, w in zip(got, want):
        for k in ('index', 'log_id', 'timestamp_ns'):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g['labels'], w['labels'])
        np.testing.assert_allclose(g['scores'], w['scores'], **TOL)
        np.testing.assert_allclose(g['boxes'], w['boxes'], **TOL)


def test_collect_and_evaluate_matches_jax(eval_runs):
    (gs, gm), (ws, wm) = eval_runs[2:]
    assert gs.keys() == ws.keys() and gs
    assert 0 < wm['mAP'] < 1 and 0 < wm['CDS'] < 1
    for cat in ws:
        assert gs[cat]['num_gts'] == ws[cat]['num_gts']
        assert gs[cat]['AP'] == ws[cat]['AP']
        for k in ('ATE', 'ASE', 'AOE', 'CDS'):
            np.testing.assert_allclose(gs[cat][k], ws[cat][k], **TOL,
                                       err_msg=(cat, k))
    assert gm.keys() == wm.keys()
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], **TOL, err_msg=k)


def test_uint8_images_normalize_bitwise_like_jax():
    """The bf16 tensor the backbone gets from uint8 images, in both
    packages (the JAX side captured by a flax method interceptor)."""
    jax_cfg, port_cfg = make_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg)
    n = port_cfg.data.num_cams
    h, w = port_cfg.data.input_hw
    u8 = np.random.RandomState(5).randint(0, 256, (1, n, h, w, 3)
                                          ).astype(np.uint8)
    eye = np.tile(np.eye(4, dtype=np.float32), (1, n, 1, 1))
    inputs = dict(lidar2img=eye, intrinsics=eye, extrinsics=eye,
                  prev_exists=np.zeros(1, np.float32),
                  timestamp=np.zeros(1, np.float32),
                  ego_pose=np.eye(4, dtype=np.float32)[None],
                  ego_pose_inv=np.eye(4, dtype=np.float32)[None])

    class Captured(Exception):
        pass

    captured = {}

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxVoVNet):
            captured['jax'] = np.asarray(args[0].astype(jnp.float32))
            assert args[0].dtype == jnp.bfloat16
            raise Captured
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor), pytest.raises(Captured):
        JaxFar3D(jax_cfg).apply(variables, images=jnp.asarray(u8),
                                state=jax_init_state(1, jax_cfg.head),
                                **{k: jnp.asarray(v) for k, v in inputs.items()})

    def capture(module, args):
        captured['port'] = args[0]
        raise Captured

    model = port_model(port_cfg, sd)
    model.img_backbone.register_forward_pre_hook(capture)
    with pytest.raises(Captured), torch.no_grad():
        model(images=torch.from_numpy(u8),
              state=port_init_state(1, port_cfg.head, 'cpu'),
              **{k: torch.from_numpy(v) for k, v in inputs.items()})
    x = captured['port']
    assert x.dtype == torch.bfloat16
    got = x.permute(0, 2, 3, 1).float().numpy().reshape(captured['jax'].shape)
    np.testing.assert_array_equal(got, captured['jax'])


# ---------------------------------------------------------- init, overrides
def test_init_state_dict_draws_from_the_jax_initializers():
    cfg = tcfg.tiny_test_config()
    state, _ = jax_train_state(jcfg.tiny_test_config(), jax.random.PRNGKey(0),
                               batch=1)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        'params': state.params, 'stats': state.stats,
        'batch_stats': state.batch_stats}), cfg)
    got = init_state_dict(cfg, seed=0)
    assert got.keys() == want.keys()
    drawn = 0
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        assert g.shape == w.shape, k
        if w.numel() == 1 or float(w.std()) == 0:
            assert torch.equal(g, w), k
        elif w.numel() >= 256:
            drawn += 1
            ratio = float(g.std() / w.std())
            assert 0.8 < ratio < 1.25, (k, ratio)
            assert abs(float(g.mean() - w.mean())) < 0.2 * float(w.std()), k
        else:
            assert float(g.std()) > 0, k
    assert drawn > 20


@pytest.mark.parametrize('overrides', [
    ['train.lr=1e-4', 'head.dn_groups=8'],
    ['data.input_hw=(320, 480)', 'train.use_grid_mask=False',
     'deform.dropout=0'],
])
def test_apply_overrides_matches_jax(overrides):
    got = tcfg.apply_overrides(tcfg.Far3DConfig(), overrides)
    want = jcfg.apply_overrides(jcfg.Far3DConfig(), overrides)
    want = dataclasses.asdict(want)
    want['deform'].pop('use_pallas')
    assert dataclasses.asdict(got) == want
    for bad in (['train.nope=1'], ['train.lr']):
        with pytest.raises((KeyError, ValueError)):
            tcfg.apply_overrides(tcfg.Far3DConfig(), bad)
