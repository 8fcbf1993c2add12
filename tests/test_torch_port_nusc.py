"""The port's nuScenes path for StreamPETR against the JAX package's, on the
CPU at ``tiny_petr_config()``:

* ``data/nuscenes_dataset.py``: every frame record equal to the JAX
  dataset's on one info pkl (9-dim boxes, attributes, an unknown class, an
  invalid box, quaternion poses, 2D annotations on one frame), and the
  sequence flags with and without a split;
* ``eval/nuscenes_metrics.py``: each test of tests/test_nuscenes_metrics.py
  run with its ``evaluate_nuscenes`` and ``default_attributes`` calls going
  to both packages, every result equal (atol 1e-9, NaN where JAX has NaN);
* ``utils/synthetic.py:make_learnable_nusc_dataset``: the JAX writer's
  infos (paths aside: .png for .jpg) and its images pixel for pixel; with
  ``image_format='jpg'`` its infos and JPEG files byte for byte;
* ``eval/petr_runner.py``: ``run_inference_petr`` on shared weights over the
  same frames (f32 images), and ``collect_and_evaluate_nusc`` of both runs
  against GT placed near the JAX detections: equal detections within the
  composed parity tolerance, mAP, NDS and the TP errors within it;
* the four CLIs with ``--device cpu`` on a PNG fixture: ``train_nusc``
  (2 steps, a checkpoint), ``test_nusc`` on it, with ``--quant`` too,
  ``overfit_nusc_demo`` (2 steps: its gate fails, exit 1, one curve line;
  its --dropout and --image-format jpg)
  and ``quant_accuracy_nusc`` (its JSON report).
"""

import dataclasses
import json
import pickle

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_nuscenes_metrics as jtests
from _torch_port_setup import TOL
from far3d_tpu.data.nuscenes_dataset import NUSC_CLASSES as JAX_NUSC_CLASSES
from far3d_tpu.data.nuscenes_dataset import NuScenesSequenceDataset as JaxDs
from far3d_tpu.eval import nuscenes_metrics as jmetrics
from far3d_tpu.eval import petr_runner as jrunner
from far3d_tpu.models import streampetr as jsp
from far3d_tpu.utils import synthetic as jsynth
from far3d_tpu_torch.data import image_io
from far3d_tpu_torch.data.loader import EvalLoader
from far3d_tpu_torch.data.nuscenes_dataset import (NUSC_CLASSES,
                                                   NuScenesSequenceDataset)
from far3d_tpu_torch.eval import nuscenes_metrics as tmetrics
from far3d_tpu_torch.eval import petr_runner as trunner
from far3d_tpu_torch.models import streampetr as tsp
from far3d_tpu_torch.utils import synthetic as tsynth
from far3d_tpu_torch.utils.convert import petr_from_jax_variables
from test_torch_port_petr import petr_frame, random_leaves


# ------------------------------------------------------------------ dataset
def _quat(yaw):
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


@pytest.fixture(scope='module')
def nusc_pkl(tmp_path_factory):
    rng = np.random.RandomState(0)
    infos = []
    for i in range(5):
        cams = {f'CAM_{c}': dict(
            data_path=f'samples/CAM_{c}/{i}.png',
            cam_intrinsic=np.array([[1000., 0, 800], [0, 1000., 450],
                                    [0, 0, 1]]),
            sensor2lidar_rotation=cv2.Rodrigues(rng.randn(3) * 0.3)[0],
            sensor2lidar_translation=rng.randn(3)) for c in range(2)}
        boxes = rng.uniform(-30, 30, (4, 9)).astype(np.float32)
        boxes[:, 3:6] = rng.uniform(1, 4, (4, 3))
        info = dict(
            scene_token='scene0' if i < 3 else 'scene1',
            timestamp=(5 - i) * 500000 if i == 4 else i * 500000,
            lidar2ego_rotation=_quat(0.1 * i),
            lidar2ego_translation=rng.randn(3),
            ego2global_rotation=_quat(-0.2 * i),
            ego2global_translation=np.array([i * 5.0, 1.0, 0]),
            cams=cams, gt_boxes=boxes,
            gt_names=np.array(['car', 'truck', 'unknown_thing', 'bus']),
            valid_flag=np.array([True, True, True, i != 2]),
            gt_attrs=np.array(['vehicle.moving', 'vehicle.parked', '',
                               'no.such.attr']))
        if i == 1:
            info['annos'] = dict(
                bboxes2d=[rng.rand(2, 4) * 100, rng.rand(1, 4) * 100],
                labels2d=[[0, 1], [3]], centers2d=[rng.rand(2, 2) * 100,
                                                   rng.rand(1, 2) * 100],
                depths=[[5.0, 7.0], [9.0]])
        infos.append(info)
    path = tmp_path_factory.mktemp('nusc') / 'infos.pkl'
    with open(path, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    return str(path)


def _same(got, want, path):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f'{path}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize('seq_split_num', [1, 2])
def test_nuscenes_dataset_matches_jax(nusc_pkl, seq_split_num):
    want = JaxDs(nusc_pkl, '/data/nusc', seq_split_num=seq_split_num)
    got = NuScenesSequenceDataset(nusc_pkl, '/data/nusc',
                                  seq_split_num=seq_split_num)
    assert NUSC_CLASSES == JAX_NUSC_CLASSES
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got.flag, want.flag)
    for i in range(len(want)):
        _same(got.get_frame(i), want.get_frame(i), f'frame {i}')
    assert 'gt_attrs' in got.get_frame(0)
    assert len(got.get_frame(1)['gt_bboxes_2d'][0]) == 2


# ------------------------------------------------------------------ metrics
def _same_metrics(got, want):
    (gs, gm), (ws, wm) = got, want
    assert gs.keys() == ws.keys() and gm.keys() == wm.keys()
    for c in ws:
        assert gs[c].keys() == ws[c].keys()
        for k in ws[c]:
            np.testing.assert_allclose(gs[c][k], ws[c][k], rtol=0, atol=1e-9,
                                       err_msg=(c, k))
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=0, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize('name', sorted(
    n for n in dir(jtests) if n.startswith('test_')))
def test_nuscenes_metrics_match_jax(name, monkeypatch):
    calls = []

    def evaluate(dts, gts, cfg=None):
        want = jmetrics.evaluate_nuscenes(dts, gts, cfg)
        port_cfg = None if cfg is None else tmetrics.NuScenesDetectionConfig(
            **dataclasses.asdict(cfg))
        _same_metrics(tmetrics.evaluate_nuscenes(dts, gts, port_cfg), want)
        calls.append(name)
        return want

    def attrs(names, labels, velocities):
        want = jmetrics.default_attributes(names, labels, velocities)
        np.testing.assert_array_equal(
            tmetrics.default_attributes(names, labels, velocities), want)
        calls.append(name)
        return want

    monkeypatch.setattr(jtests, 'evaluate_nuscenes', evaluate)
    monkeypatch.setattr(jtests, 'default_attributes', attrs)
    getattr(jtests, name)()
    assert calls
    assert tmetrics.NUSC_ATTRIBUTES == jmetrics.NUSC_ATTRIBUTES


# ------------------------------------------------------- learnable dataset
def test_learnable_nusc_writer_matches_jax(tmp_path, monkeypatch):
    """The same infos (paths aside) and the same images pixel for pixel:
    the JAX writer's ``cv2.imwrite`` is made to encode PNG (lossless) into
    its .jpg paths, which ``cv2.imread`` reads by content."""
    def lossless(path, img, *args):
        with open(path, 'wb') as f:
            f.write(cv2.imencode('.png', img)[1].tobytes())
        return True

    jroot, troot = tmp_path / 'jax', tmp_path / 'port'
    kw = dict(frames_per_scene=3)
    with monkeypatch.context() as m:
        m.setattr(cv2, 'imwrite', lossless)
        want = jsynth.make_learnable_nusc_dataset(str(jroot / 'i.pkl'),
                                                  str(jroot), **kw)
    got = tsynth.make_learnable_nusc_dataset(str(troot / 'i.pkl'),
                                             str(troot), **kw)
    paths = []
    for w in want:
        for cam in w['cams'].values():
            paths.append(cam['data_path'])
            cam['data_path'] = cam['data_path'].replace('.jpg', '.png')
    _same(got, want, 'infos')
    drawn = 0
    for path in paths:
        jimg = cv2.imread(str(jroot / path))
        timg = image_io.read_png(str(troot / path.replace('.jpg', '.png')))
        np.testing.assert_array_equal(timg, jimg, err_msg=path)
        drawn += int((timg.max(-1) != timg.min(-1)).any())   # a coloured blob
    assert drawn > 0


def test_learnable_nusc_writer_jpeg_is_jax(tmp_path):
    """With image_format='jpg' the writer is the JAX one: the same infos,
    paths included, and the same JPEG files byte for byte."""
    jroot, troot = tmp_path / 'jax', tmp_path / 'port'
    kw = dict(frames_per_scene=2, seed=3)
    want = jsynth.make_learnable_nusc_dataset(str(jroot / 'i.pkl'),
                                              str(jroot), **kw)
    got = tsynth.make_learnable_nusc_dataset(str(troot / 'i.pkl'),
                                             str(troot), image_format='jpg',
                                             **kw)
    _same(got, want, 'infos')
    for w in want:
        for cam in w['cams'].values():
            path = cam['data_path']
            assert path.endswith('.jpg')
            assert (troot / path).read_bytes() == (jroot / path).read_bytes()
    with pytest.raises(ValueError):
        tsynth.make_learnable_nusc_dataset(str(troot / 'j.pkl'), str(troot),
                                           image_format='bmp', **kw)


# ------------------------------------------------------ streaming evaluation
@pytest.fixture(scope='module')
def learnable(tmp_path_factory):
    root = tmp_path_factory.mktemp('learnable')
    ann = str(root / 'infos.pkl')
    tsynth.make_learnable_nusc_dataset(ann, str(root), frames_per_scene=3)
    return ann, str(root)


class _Frames(list):
    pad = 0


@pytest.fixture(scope='module')
def eval_runs(learnable, tmp_path_factory):
    ann, root = learnable
    jc, tc = jsp.tiny_petr_config(), tsp.tiny_petr_config()
    f0 = {k: jnp.asarray(v) for k, v in petr_frame(jc, 0).items()}
    import jax
    shapes = jax.eval_shape(lambda: jsp.StreamPETR(jc).init(
        jax.random.PRNGKey(0), state=jsp.init_petr_state(1, jc), **f0))
    variables = random_leaves(shapes, 1)
    model = tsp.StreamPETR(tc)
    model.load_state_dict(petr_from_jax_variables(variables, tc))
    model.eval()
    h, w = tc.input_hw
    host = trunner.petr_host_config(tc, (w, h))
    dataset = NuScenesSequenceDataset(ann, root, seq_split_num=1)
    mean, std = torch.tensor(host.data.img_mean), torch.tensor(host.data.img_std)
    frames = _Frames()
    for f in EvalLoader(dataset, host, num_threads=2, device='cpu'):
        f['images'] = (f['images'].float() - mean) / std
        frames.append(f)
    assert [float(f['prev_exists']) for f in frames] == [0, 1, 1, 0, 1, 1]
    got = trunner.run_inference_petr(tc, model, frames, device='cpu')
    want = jrunner.run_inference_petr(jc, variables, frames)
    # score both against GT near the detections, so that the metrics are
    # not all zero: every other JAX detection, moved 0.7 m
    with open(ann, 'rb') as f:
        infos = pickle.load(f)['infos']
    for info, det in zip(infos, want):
        boxes = det['boxes'][::2].copy()
        boxes[:, 0] += 0.7
        info['gt_boxes'] = boxes.astype(np.float32)
        info['gt_names'] = np.array([NUSC_CLASSES[i]
                                     for i in det['labels'][::2]])
        info['valid_flag'] = np.ones(len(boxes), bool)
    scored = str(tmp_path_factory.mktemp('scored') / 'scored.pkl')
    with open(scored, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    got_m = trunner.collect_and_evaluate_nusc(
        NuScenesSequenceDataset(scored, root, seq_split_num=1), got)
    want_m = jrunner.collect_and_evaluate_nusc(
        JaxDs(scored, root, seq_split_num=1), want)
    return got, want, got_m, want_m


def test_run_inference_petr_matches_jax(eval_runs):
    got, want = eval_runs[:2]
    assert len(got) == len(want) == 6
    assert sum(len(w['scores']) for w in want) > 0
    for g, w in zip(got, want):
        assert g['index'] == w['index']
        np.testing.assert_array_equal(g['labels'], w['labels'])
        np.testing.assert_allclose(g['scores'], w['scores'], **TOL)
        np.testing.assert_allclose(g['boxes'], w['boxes'], **TOL)


def test_collect_and_evaluate_nusc_matches_jax(eval_runs):
    (gs, gm), (ws, wm) = eval_runs[2:]
    assert gs.keys() == ws.keys() and gs
    assert 0 < wm['mAP'] < 1 and 0 < wm['NDS'] < 1
    for c in ws:
        assert gs[c]['num_gts'] == ws[c]['num_gts']
        for k in ws[c]:
            np.testing.assert_allclose(gs[c][k], ws[c][k], **TOL,
                                       err_msg=(c, k))
    assert gm.keys() == wm.keys()
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], **TOL, err_msg=k)


# ---------------------------------------------------------------------- CLIs
def test_cli_train_and_test_nusc(learnable, tmp_path, capsys):
    from far3d_tpu_torch.cli import test_nusc, train_nusc
    ann, root = learnable
    work = tmp_path / 'work'
    base = ['--data-root', root, '--ann-file', ann, '--tiny',
            '--src-wh', '96', '64', '--device', 'cpu']
    assert train_nusc.main(base + [
        '--work-dir', str(work), '--max-iters', '2', '--log-interval', '1',
        '--ckpt-interval', '1', '--set', 'dropout=0.0']) == 0
    assert sorted(p.name for p in work.glob('*.pt')) == ['2.pt']
    lines = [json.loads(x) for x in open(work / 'metrics.jsonl')]
    assert [x['iter'] for x in lines] == [1, 2]
    assert all(np.isfinite(x['total_loss']) for x in lines)
    for extra in ([], ['--quant', '--quant-calib-frames', '2']):
        res = test_nusc.evaluate(base + ['--checkpoint', str(work)] + extra)
        assert res['frames'] == 6
        assert np.isfinite(res['means']['mAP'])
        assert 0.0 <= res['means']['NDS'] <= 1.0
    out = capsys.readouterr().out
    assert 'restored step 2' in out and 'calibrated on 2 frames' in out
    with pytest.raises(SystemExit):
        test_nusc.evaluate(base)        # neither --checkpoint nor --random-init


def test_cli_overfit_and_quant_accuracy_nusc(tmp_path, capsys):
    from far3d_tpu_torch.cli import overfit_nusc_demo, quant_accuracy_nusc
    work = tmp_path / 'ov'
    assert overfit_nusc_demo.main(['--work', str(work), '--iters', '2',
                                   '--eval-every', '2',
                                   '--device', 'cpu']) == 1
    curve = [json.loads(x) for x in open(work / 'curve.jsonl')]
    assert [c['iter'] for c in curve] == [2]
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report['gate_failures'] and report['curve'] == curve
    assert quant_accuracy_nusc.main(['--work', str(work), '--iters', '2',
                                     '--calib-frames', '2',
                                     '--device', 'cpu']) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {'bf16', 'int8', 'delta_mAP', 'delta_NDS'}
    assert all(np.isfinite(report[k]['NDS']) for k in ('bf16', 'int8'))


def test_cli_overfit_nusc_dropout_and_jpeg(tmp_path, monkeypatch):
    """--dropout reaches the trained config; --image-format jpg writes and
    trains on the JAX demo's JPEG images."""
    from far3d_tpu_torch.cli import overfit_nusc_demo
    from far3d_tpu_torch.train import runner
    seen = []
    train = runner.run_petr_training

    def spy(cfg, *args, **kw):
        seen.append(cfg.dropout)
        return train(cfg, *args, **kw)

    monkeypatch.setattr(runner, 'run_petr_training', spy)
    work = tmp_path / 'ov'
    assert overfit_nusc_demo.main(['--work', str(work), '--iters', '2',
                                   '--eval-every', '2', '--dropout', '0',
                                   '--image-format', 'jpg',
                                   '--device', 'cpu']) == 1
    assert seen == [0.0]
    with open(work / 'infos.pkl', 'rb') as f:
        infos = pickle.load(f)['infos']
    paths = [c['data_path'] for i in infos for c in i['cams'].values()]
    assert paths and all(p.endswith('.jpg') and (work / p).is_file()
                         for p in paths)
