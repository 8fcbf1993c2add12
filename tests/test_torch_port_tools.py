"""The port's diagnostic and visualization tools (``far3d_tpu_torch/cli/``)
against the JAX tools of ``tools/``, on the CPU at the tiny size.

Each port tool runs with ``--tiny --device cpu`` on a tiny learnable dataset
(the JAX writer's JPEG files) and seeded reference weights (a ``.pth``); the
JAX tool runs on the same files and weights, its ``Far3DConfig()`` made the
tiny test config. The files each tool writes exist and decode; the numbers
both tools compute are equal: the recall tables (``eval_recall``, its
``--synthetic`` curve included), mAP / CDS (``eval_aug_delta``,
``test_and_visualize``), the depth statistics (``vis_depth_stats``, at rtol
1e-3), the per-frame counts the visualizers print. The JAX tools that
restore an orbax checkpoint get the same weights through a stand-in
manager, and ``eval_aug_delta``'s JAX loader reads with one thread, so
that its random crops are drawn in frame order as the port's are.

The model tools are fed normalized f32 images (both loaders' frames, by
``f32_frames``), so that both models compute in f32: from uint8 images
both run the backbone in bf16, where the two packages' convolutions round
differently (about 1e-2 on a tiny model's logits), which moves counts at
their thresholds. (On bf16 scores the JAX ``vis_yolox`` fails to format its
max score: ``tools/vis_yolox.py:76-77``.)
"""

import importlib
import json
import pathlib
import re
import sys

import cv2
import numpy as np
import pytest
import torch

import far3d_tpu.config as jcfg
import far3d_tpu.data.loader as jloader
import far3d_tpu.utils.checkpoint as jckpt
from far3d_tpu.utils.torch_convert import (convert_state_dict,
                                           load_torch_checkpoint)
from far3d_tpu_torch.cli import (check_img_label, eval_aug_delta,
                                 eval_recall, test_and_visualize,
                                 vis_attention, vis_depth_stats, vis_yolox,
                                 visualize, visualize_nusc)
from far3d_tpu_torch.cli.overfit_demo import build_config as demo_config
from far3d_tpu_torch.config import tiny_test_config
from far3d_tpu_torch.data.image_io import read_image
from far3d_tpu_torch.utils.convert import random_reference_state_dict
from far3d_tpu_torch.utils.synthetic import (make_learnable_dataset,
                                             make_learnable_nusc_dataset)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'tools'))


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp('tools')
    make_learnable_dataset(str(root / 'infos.pkl'), str(root), n_scenes=1,
                           frames_per_scene=3)
    for name, cfg in (('w.pth', tiny_test_config()),
                      ('demo.pth', demo_config(iters=1))):
        torch.save({'state_dict': random_reference_state_dict(cfg, seed=3)},
                   root / name)
    return root


@pytest.fixture
def f32_frames(monkeypatch):
    """Both eval loaders hand out normalized f32 images in place of uint8."""
    import far3d_tpu_torch.data.loader as tloader

    for module in (jloader, tloader):
        def frame(rec, cfg, rng, train, _orig=module.process_frame):
            out = _orig(rec, cfg, rng, train=train)
            mean = np.asarray(cfg.data.img_mean, np.float32)
            std = np.asarray(cfg.data.img_std, np.float32)
            out['images'] = (out['images'].astype(np.float32) - mean) / std
            return out
        monkeypatch.setattr(module, 'process_frame', frame)


def _common(root, out, weights='w.pth'):
    return ['--data-root', str(root), '--ann-file', str(root / 'infos.pkl'),
            '--torch-checkpoint', str(root / weights), '--out-dir', str(out),
            '--num-frames', '2']


def _run_jax_tool(monkeypatch, capsys, name, argv, cfg=None, weights=None):
    """Run tools/<name>.py's main with `argv` at the tiny size; -> stdout."""
    cfg = cfg or jcfg.tiny_test_config()
    full = jcfg.Far3DConfig
    monkeypatch.setattr(jcfg, 'Far3DConfig',
                        lambda *a, **kw: full(*a, **kw) if a or kw else cfg)
    if weights is not None:
        class Manager:                 # restores the converted .pth
            def __init__(self, *args, **kw):
                pass

            def restore(self, state):
                out, _ = convert_state_dict(
                    load_torch_checkpoint(str(weights)), cfg,
                    {'params': state.params, 'stats': state.stats,
                     'batch_stats': state.batch_stats})
                return state.replace(params=out['params'],
                                     stats=out['stats'],
                                     batch_stats=out['batch_stats'])
        monkeypatch.setattr(jckpt, 'CheckpointManager', Manager)
    monkeypatch.setattr(sys, 'argv', [name] + argv)
    capsys.readouterr()
    importlib.import_module(name).main()
    return capsys.readouterr().out


def _port(capsys, fn, argv):
    capsys.readouterr()
    rc = fn(argv + ['--tiny', '--device', 'cpu'])
    return rc, capsys.readouterr().out


def _decodes(paths):
    paths = sorted(paths)
    assert paths
    for p in paths:
        img = read_image(str(p))
        assert img.ndim == 3 and img.shape[2] == 3
        np.testing.assert_array_equal(img, cv2.imread(str(p)))
    return paths


def _frame_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith('frame ')]


def test_eval_recall_synthetic_curve_is_jaxs(monkeypatch, capsys):
    jtool = importlib.import_module('eval_recall')
    kw = dict(ks=(32, 64, 128), n_frames=2, gt_per_frame=60)
    want = jtool.synthetic_recall_curve(**kw)
    got = eval_recall.synthetic_recall_curve(**kw)
    assert got == want and 0 < min(got.values()) <= max(got.values()) <= 1
    rc, out = _port(capsys, eval_recall.main,
                    ['--synthetic', '--gt-per-frame', '30'])
    assert rc == 0 and out.count('GT-peak recall') == 6


def test_eval_recall_table_is_jaxs(fixture, f32_frames, monkeypatch, capsys):
    argv = ['--data-root', str(fixture), '--ann-file',
            str(fixture / 'infos.pkl'), '--num-frames', '3',
            '--iou-thr', '0.1']
    want = _run_jax_tool(monkeypatch, capsys, 'eval_recall',
                         argv + ['--checkpoint', 'unused'],
                         weights=fixture / 'w.pth')
    rc, got = _port(capsys, eval_recall.main,
                    argv + ['--torch-checkpoint', str(fixture / 'w.pth')])
    lines = [ln for ln in got.splitlines() if ln.startswith('range')]
    assert rc == 0 and len(lines) == 3
    assert lines == [ln for ln in want.splitlines()
                     if ln.startswith('range')]
    assert sum(int(re.search(r'/(\d+)\)', ln).group(1)) for ln in lines) > 0


def _record_augmentation(monkeypatch, module):
    """Every resize / crop the pipeline of `module` draws, with its train
    flag, in call order."""
    calls, orig = [], module.sample_augmentation

    def record(rng, dcfg, h, w, train):
        out = orig(rng, dcfg, h, w, train)
        calls.append((train, repr(out)))
        return out
    monkeypatch.setattr(module, 'sample_augmentation', record)
    return calls


def test_eval_aug_delta_is_jaxs(fixture, f32_frames, monkeypatch, capsys):
    """mAP / CDS of the deterministic and the random-crop evaluation, and
    every crop drawn, equal to the JAX tool's (untrained weights: both
    packages score 0 here, so the draws are what this test holds)."""
    import far3d_tpu.data.pipeline as jpl
    import far3d_tpu_torch.data.pipeline as tpl

    class OneThread(jloader.EvalLoader):
        def __init__(self, *args, **kw):
            super().__init__(*args, **dict(kw, num_threads=1))
    monkeypatch.setattr(jloader, 'EvalLoader', OneThread)
    jdraws = _record_augmentation(monkeypatch, jpl)
    tdraws = _record_augmentation(monkeypatch, tpl)
    jax_demo = importlib.import_module('overfit_demo').build_config(iters=1)
    want = _run_jax_tool(monkeypatch, capsys, 'eval_aug_delta',
                         ['--work', str(fixture), '--seeds', '1'],
                         cfg=jax_demo, weights=fixture / 'demo.pth')
    capsys.readouterr()
    got = eval_aug_delta.run(['--work', str(fixture), '--seeds', '1',
                              '--torch-checkpoint',
                              str(fixture / 'demo.pth'), '--device', 'cpu'])
    jlines = [ln for ln in want.strip().splitlines() if ": {" in ln]
    assert len(jlines) == 2, want
    det = json.loads(jlines[0].split(':', 1)[1])
    rand = json.loads(jlines[1].split(':', 1)[1])
    for name in ('mAP', 'CDS'):
        assert got['deterministic'][name] == pytest.approx(det[name],
                                                           abs=1e-6)
        assert got['random'][0][name] == pytest.approx(rand[name], abs=1e-6)
    assert tdraws == jdraws and any(train for train, _ in tdraws)


def test_vis_depth_stats_is_jaxs(fixture, f32_frames, tmp_path, monkeypatch,
                                capsys):
    _run_jax_tool(monkeypatch, capsys, 'vis_depth_stats',
                  _common(fixture, tmp_path / 'jax') + ['--score-thr', '0.0'])
    rc, _ = _port(capsys, vis_depth_stats.main,
                  _common(fixture, tmp_path / 'port') + ['--score-thr', '0.0'])
    assert rc == 0
    want = json.loads((tmp_path / 'jax' / 'depth_stats.json').read_text())
    got = json.loads((tmp_path / 'port' / 'depth_stats.json').read_text())
    assert got.keys() == want.keys()
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g['range'] == w['range'] and g['n'] == w['n']
            if w['mae'] is None:
                assert g['mae'] is None
            else:
                assert g['mae'] == pytest.approx(w['mae'], rel=1e-3)
    assert sum(r['n'] for r in got['depth_branch']) > 0
    pngs = sorted((tmp_path / 'port').glob('depth_stat_*.png'))
    assert [p.name for p in pngs] == sorted(
        p.name for p in (tmp_path / 'jax').glob('depth_stat_*.png'))
    _decodes(pngs)


@pytest.mark.parametrize('name', ['visualize', 'vis_yolox', 'vis_attention'])
def test_visualizers_are_jaxs(fixture, f32_frames, tmp_path, monkeypatch,
                              capsys, name):
    """The files of the JAX tool, decodable, and its printed counts."""
    extra = ['--score-thr', '0.0'] if name != 'vis_yolox' else []
    want = _run_jax_tool(monkeypatch, capsys, name,
                         _common(fixture, tmp_path / 'jax') + extra)
    port = {'visualize': visualize, 'vis_yolox': vis_yolox,
            'vis_attention': vis_attention}[name]
    rc, got = _port(capsys, port.main,
                    _common(fixture, tmp_path / 'port') + extra)
    assert rc == 0
    files = _decodes((tmp_path / 'port').glob('*.jpg'))
    assert [p.name for p in files] == sorted(
        p.name for p in (tmp_path / 'jax').glob('*.jpg'))
    g, w = _frame_lines(got), _frame_lines(want)
    assert len(g) == len(w) == 2
    if name == 'vis_yolox':        # the max score printed to 3 decimals
        num = re.compile(r'frame (\d+): (\d+) proposals > thr '
                         r'\(max score ([\d.]+)\)')
        for a, b in zip(g, w):
            ma, mb = num.match(a).groups(), num.match(b).groups()
            assert ma[:2] == mb[:2]
            assert float(ma[2]) == pytest.approx(float(mb[2]), abs=1.5e-3)
    else:
        assert g == w


def test_test_and_visualize_is_jaxs(fixture, f32_frames, tmp_path,
                                    monkeypatch, capsys):
    want = _run_jax_tool(monkeypatch, capsys, 'test_and_visualize',
                         _common(fixture, tmp_path / 'jax')
                         + ['--score-thr', '0.0'])
    capsys.readouterr()
    means = test_and_visualize.run(_common(fixture, tmp_path / 'port')
                                   + ['--score-thr', '0.0', '--tiny',
                                      '--device', 'cpu'])
    jmeans = eval(want.strip().splitlines()[-1],
                  {'np': np, 'nan': float('nan')})
    assert set(means) == set(jmeans)
    for k, v in jmeans.items():
        assert round(float(means[k]), 4) == pytest.approx(v, abs=1.5e-4), k
    files = _decodes((tmp_path / 'port').glob('*.jpg'))
    assert [p.name for p in files] == sorted(
        p.name for p in (tmp_path / 'jax').glob('*.jpg'))


@pytest.mark.parametrize('aug', [[], ['--train-aug', '--seed', '5']])
def test_check_img_label_is_jaxs(fixture, tmp_path, monkeypatch, capsys,
                                 aug):
    argv = ['--data-root', str(fixture), '--ann-file',
            str(fixture / 'infos.pkl'), '--num-frames', '2'] + aug
    want = _run_jax_tool(monkeypatch, capsys, 'check_img_label',
                         argv + ['--out-dir', str(tmp_path / 'jax')])
    rc, got = _port(capsys, check_img_label.main,
                    argv + ['--out-dir', str(tmp_path / 'port')])
    assert rc == 0 and _frame_lines(got) == _frame_lines(want)
    files = _decodes((tmp_path / 'port').glob('*.jpg'))
    assert [p.name for p in files] == sorted(
        p.name for p in (tmp_path / 'jax').glob('*.jpg'))


def test_visualize_nusc_is_jaxs(tmp_path, f32_frames, monkeypatch, capsys):
    """The StreamPETR composite tool on a tiny nuScenes dataset: the port
    from a checkpoint of the very weights the JAX tool's --random-init
    draws (flax's init at PRNGKey(0), carried across by
    ``petr_from_jax_variables``), so the printed counts are equal; the box
    conversion and the composite's layout are the JAX renderer's."""
    import jax
    import jax.numpy as jnp

    import far3d_tpu.models.streampetr as jsp
    from far3d_tpu.models.streampetr import init_petr_state
    from far3d_tpu_torch.config import TrainConfig
    from far3d_tpu_torch.data.nuscenes_dataset import NuScenesSequenceDataset
    from far3d_tpu_torch.entry import build_petr_model
    from far3d_tpu_torch.models.streampetr import tiny_petr_config
    from far3d_tpu_torch.train.petr_step import create_petr_train_state
    from far3d_tpu_torch.utils.checkpoint import CheckpointManager
    from far3d_tpu_torch.utils.convert import petr_from_jax_variables

    jtool = importlib.import_module('visualize_nusc')
    make_learnable_nusc_dataset(str(tmp_path / 'v.pkl'), str(tmp_path),
                                n_scenes=1, frames_per_scene=2)
    jcfg_petr = jsp.tiny_petr_config()
    h, w = jcfg_petr.input_hw
    n = jcfg_petr.num_cams
    variables = jax.jit(jsp.StreamPETR(jcfg_petr).init)(
        jax.random.PRNGKey(0), images=jnp.zeros((1, n, h, w, 3)),
        lidar2img=jnp.tile(jnp.eye(4)[None, None], (1, n, 1, 1)),
        state=init_petr_state(1, jcfg_petr), prev_exists=jnp.zeros((1,)),
        timestamp=jnp.zeros((1,)), ego_pose=jnp.eye(4)[None],
        ego_pose_inv=jnp.eye(4)[None])
    cfg = tiny_petr_config()
    model = build_petr_model(cfg, 'cpu', weights=petr_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    state, _ = create_petr_train_state(model, TrainConfig())
    CheckpointManager(str(tmp_path / 'work')).save(1, state, force=True)

    argv = ['--data-root', str(tmp_path), '--ann-file',
            str(tmp_path / 'v.pkl'), '--src-wh', '96', '64',
            '--score-thr', '0.0', '--num-frames', '2']
    monkeypatch.setattr(jsp, 'StreamPETRConfig', lambda: jcfg_petr)
    monkeypatch.setattr(sys, 'argv', ['visualize_nusc'] + argv + [
        '--random-init', '--out-dir', str(tmp_path / 'jax')])
    capsys.readouterr()
    jtool.main()
    want = capsys.readouterr().out
    rc, got = _port(capsys, visualize_nusc.main, argv + [
        '--checkpoint', str(tmp_path / 'work'), '--out-dir',
        str(tmp_path / 'port')])
    assert rc == 0 and len(_frame_lines(got)) == 2
    assert _frame_lines(got) == _frame_lines(want)
    assert any(int(ln.split()[2]) > 0 for ln in _frame_lines(got))
    files = _decodes((tmp_path / 'port').glob('frame*.jpg'))
    assert [p.name for p in files] == sorted(
        p.name for p in (tmp_path / 'jax').glob('frame*.jpg'))
    rec = NuScenesSequenceDataset(str(tmp_path / 'v.pkl'), str(tmp_path),
                                  seq_split_num=1).get_frame(0)
    det = dict(boxes=np.array([[8.0, 0.0, 1.0, 1.2, 1.0, 1.2, 0.3, 0, 0]]),
               scores=np.array([0.9]), labels=np.array([0]))
    for bottom in (True, False):
        np.testing.assert_array_equal(
            visualize_nusc._to_draw_boxes(det['boxes'], bottom),
            jtool._to_draw_boxes(det['boxes'], bottom))
    got = visualize_nusc.render_nusc_frame(rec, det)
    want = jtool.render_nusc_frame(rec, det)
    assert got.shape == want.shape and got.dtype == want.dtype
