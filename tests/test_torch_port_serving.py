"""The port's serving path against the JAX package's, on the CPU at the tiny
size: the int8 backbone hook of the detector, the HD-map ROI gate
(eval/map_roi.py with data.image_io.fill_poly in place of cv2.fillPoly), the
AV2 Feather submission (eval.runner.format_av2_submission written by
utils/feather.py) and the test CLI with all three.

* ``Far3D.forward(..., quant_backbone=tree)`` against the JAX
  ``quant_backbone=`` hook on shared weights and the same tree, two streaming
  frames of uint8 images: what reaches the FPN is bitwise the JAX int8
  backbone's output; downstream (bf16 on both sides) at the tolerances the
  test states with their reason.
* ``fill_poly`` equals ``cv2.fillPoly`` pixel for pixel on random convex and
  concave polygons with integer vertices.
* Twins of tests/test_map_roi.py, each run against both packages, the
  rasters equal.
* pandas (through pyarrow) reads the port's Feather file into a frame equal
  to the JAX package's ``format_av2_submission`` frame.
"""

import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import far3d_tpu_torch.config as tcfg
from _torch_port_setup import (TOL, make_cfgs, port_model, shared_weights,
                               to_np)
from far3d_tpu.eval import map_roi as jroi
from far3d_tpu.eval import runner as jax_eval
from far3d_tpu.eval.av2_metrics import DetectionConfig as JaxDetectionConfig
from far3d_tpu.eval.av2_metrics import evaluate_detections as jax_evaluate
from far3d_tpu.models.detector import Far3D as JaxFar3D
from far3d_tpu.models.detector import decode_detections as jax_decode
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.ops import quant as jq
from far3d_tpu_torch.data.image_io import fill_poly, write_png
from far3d_tpu_torch.entry import build_model
from far3d_tpu_torch.eval import map_roi as troi
from far3d_tpu_torch.eval import runner as port_eval
from far3d_tpu_torch.eval.av2_metrics import DetectionConfig
from far3d_tpu_torch.eval.av2_metrics import evaluate_detections
from far3d_tpu_torch.models.detector import decode_detections
from far3d_tpu_torch.models.farhead import init_state as torch_init_state
from far3d_tpu_torch.ops import quant as tq
from far3d_tpu_torch.train.step import create_train_state
from far3d_tpu_torch.utils.checkpoint import CheckpointManager
from far3d_tpu_torch.utils.feather import num_rows, write_feather
from test_data import make_fake_infos
from test_map_roi import SQUARE, write_map_archive
from test_torch_port_model import _frames

# ------------------------------------------------------- the detector's hook
def test_detector_quant_hook_matches_jax():
    jax_cfg, port_cfg = make_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg)
    model = port_model(port_cfg, sd)
    frames = _frames(jax_cfg)
    rng = np.random.RandomState(5)
    for f in frames:
        f['images'] = rng.randint(0, 256, f['images'].shape).astype(np.uint8)
    # one tree for both: JAX calibration on the first frame's images
    jvars = {'params': variables['params']['backbone'],
             'stats': variables['stats']['backbone']}
    mean, std = jax_cfg.data.img_mean, jax_cfg.data.img_std

    def normalized(images):
        return jnp.asarray((images[0].astype(np.float32) - np.asarray(mean))
                           / np.asarray(std), jnp.bfloat16)

    amax = jq.calibrate_vovnet(jax_cfg.backbone, jvars,
                               [normalized(frames[0]['images'])])
    jtree = jq.build_quant_vovnet(jax_cfg.backbone, jvars, amax, mean, std)
    ttree = tq.build_quant_vovnet(model.img_backbone, amax, mean, std)

    neck_in = []
    model.img_neck.register_forward_pre_hook(
        lambda m, args: neck_in.append(args[0]))
    japply = jax.jit(JaxFar3D(jax_cfg).apply)
    jstate = jax_init_state(1, jax_cfg.head)
    tstate = torch_init_state(1, port_cfg.head, 'cpu')
    nq = jax_cfg.head.num_query
    for i, f in enumerate(frames):
        want = japply(variables, state=jstate, quant_backbone=jtree,
                      **{k: jnp.asarray(v) for k, v in f.items()})
        jstate = want['state']
        with torch.no_grad():
            got = model(state=tstate, quant_backbone=ttree,
                        **{k: torch.from_numpy(np.array(v))
                           for k, v in f.items()})
        tstate = got['state']
        # what the hook hands the FPN: bitwise the JAX int8 backbone's
        # stages, from the same uint8 images
        jstages = jq.quant_vovnet_forward(
            jax_cfg.backbone, jtree,
            jq.quantize_input(normalized(f['images']), jtree['s0']))
        assert len(neck_in[-1]) == len(jstages) == 4
        for t, j in zip(neck_in[-1], jstages):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.permute(0, 2, 3, 1).float().numpy(),
                np.asarray(j, np.float32), err_msg=f'frame {i}')
        # downstream, the image side runs in bf16 on both sides (FPN, 2D
        # head, sampled pyramid) and XLA and PyTorch round its convs at
        # other places; with random weights the 2D scores and the decoded
        # scores are near-ties (all within ~1e-2 for one class), so which
        # proposal and which query ranks where is decided by that rounding.
        # Held: the regular (non-proposal) queries' last-layer logits and
        # boxes within 0.1, the decoded scores as sorted lists within 1e-2,
        # the decoded labels as multisets, the carried memory's ego pose and
        # timestamps within TOL.
        for name in ('all_cls_scores', 'all_bbox_preds'):
            np.testing.assert_allclose(
                to_np(got[name])[-1, :, :nq],
                np.asarray(want[name])[-1, :, :nq],
                rtol=0, atol=0.1, err_msg=f'{name} frame {i}')
        jd = jax_decode(want['all_cls_scores'][-1], want['all_bbox_preds'][-1],
                        want['query_valid'], jax_cfg)
        td = decode_detections(got['all_cls_scores'][-1],
                               got['all_bbox_preds'][-1], got['query_valid'],
                               port_cfg)
        np.testing.assert_allclose(np.sort(to_np(td['scores'])[0]),
                                   np.sort(np.asarray(jd['scores'])[0]),
                                   rtol=0, atol=1e-2, err_msg=f'frame {i}')
        assert sorted(to_np(td['labels'])[0]) == \
            sorted(np.asarray(jd['labels'])[0])
        for field in ('egopose', 'timestamp'):
            np.testing.assert_allclose(
                to_np(getattr(tstate, field)),
                np.asarray(getattr(jstate, field)),
                err_msg=f'state.{field} frame {i}', **TOL)


# ------------------------------------------------------------------ the ROI
def _polygons(seed, count):
    """Random polygons with integer vertices inside an h x w image: convex,
    star-shaped (concave) and free (self-intersecting), in turn."""
    rng = np.random.RandomState(seed)
    for t in range(count):
        h, w = rng.randint(4, 200), rng.randint(4, 200)
        n = rng.randint(3, 24)
        if t % 3 == 2:
            pts = np.stack([rng.rand(n) * (w - 1), rng.rand(n) * (h - 1)], 1)
        else:
            r = min(h, w) / 2 * (rng.rand() if t % 3 == 0
                                 else 0.3 + 0.7 * rng.rand(n))
            ang = np.sort(rng.rand(n) * 2 * np.pi)
            pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)],
                           1)
        yield h, w, np.clip(np.round(pts), 0, [w - 1, h - 1]).astype(np.int32)


@pytest.mark.parametrize('seed', [0, 1])
def test_fill_poly_matches_cv2(seed):
    for h, w, pts in _polygons(seed, 150):
        want = np.zeros((h, w), np.uint8)
        got = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        fill_poly(got, pts, (1,))
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))
    img_w, img_g = np.zeros((30, 40, 3), np.uint8), np.zeros((30, 40, 3),
                                                             np.uint8)
    tri = np.array([[2, 3], [35, 8], [10, 27]], np.int32)
    cv2.fillPoly(img_w, [tri], (10, 200.6, 255))
    fill_poly(img_g, tri, (10, 200.6, 255))
    np.testing.assert_array_equal(img_g, img_w)


def test_fill_poly_refuses_vertices_outside():
    with pytest.raises(ValueError, match='inside the image'):
        fill_poly(np.zeros((5, 5), np.uint8), [[0, 0], [5, 0], [0, 4]], (1,))


L_SHAPE = [(0.0, 0.0), (30.0, 0.0), (30.0, 8.0), (9.5, 8.0), (9.5, 25.3),
           (0.0, 25.3)]


@pytest.mark.parametrize('polys', [[SQUARE], [L_SHAPE, SQUARE]])
def test_load_and_rasterize_equals_jax(tmp_path, polys):
    write_map_archive(str(tmp_path / 'map'), polys)
    got_p = troi.load_drivable_polygons(str(tmp_path / 'map'))
    want_p = jroi.load_drivable_polygons(str(tmp_path / 'map'))
    assert len(got_p) == len(want_p) == len(polys)
    for a, b in zip(got_p, want_p):
        np.testing.assert_array_equal(a, b)
    roi, want = troi.rasterize_roi(got_p), jroi.rasterize_roi(want_p)
    assert roi.origin_xy == want.origin_xy and roi.resolution_m == 0.1
    np.testing.assert_array_equal(roi.grid, want.grid)
    undilated = troi.rasterize_roi(got_p, dilate_m=0.0)
    np.testing.assert_array_equal(
        undilated.grid, jroi.rasterize_roi(want_p, dilate_m=0.0).grid)
    # the same points as tests/test_map_roi.py
    inside = [[10.0, 10.0], [23.0, 10.0], [-3.0, -3.0]]
    outside = [[26.0, 10.0] if len(polys) == 1 else [36.0, 10.0],
               [-4.0, -4.0], [500.0, 500.0]]
    assert roi.contains(np.array(inside)).all()
    assert not roi.contains(np.array(outside)).any()


def test_sweep_roi_equals_jax(tmp_path):
    write_map_archive(str(tmp_path / 'map'), [SQUARE])
    mat = np.eye(4)
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    mat[:2, :2] = [[c, -s], [s, c]]
    mat[:2, 3] = [40.0, 10.0]
    sweep = troi.SweepROI(troi.rasterize_roi(troi.load_drivable_polygons(
        str(tmp_path / 'map'))), mat)
    want = jroi.SweepROI(jroi.rasterize_roi(jroi.load_drivable_polygons(
        str(tmp_path / 'map'))), mat)
    xy = np.random.RandomState(0).uniform(-40, 40, (500, 2))
    np.testing.assert_array_equal(sweep.contains(xy), want.contains(xy))
    assert sweep.contains(np.array([[0.0, 25.0]]))[0]
    assert not sweep.contains(np.array([[25.0, 0.0]]))[0]


def test_lazy_masks_and_builder_equal_jax(tmp_path):
    root = tmp_path / 'sensor'
    write_map_archive(str(root / 'val' / 'LOG0' / 'map'), [SQUARE],
                      log_id='LOG0')

    class FakeDataset:
        infos = [dict(scene_id='LOG0', lidar_timestamp_ns=7,
                      city_SE3_ego_lidar_t=np.eye(4))]

        def __len__(self):
            return 1

    masks = troi.build_roi_masks(FakeDataset(), str(root))
    want = jroi.build_roi_masks(FakeDataset(), str(root))
    assert masks.map_dirs == want.map_dirs
    sweep = masks.get(('LOG0', 7))
    np.testing.assert_array_equal(sweep.city_roi.grid,
                                  want.get(('LOG0', 7)).city_roi.grid)
    assert sweep.contains(np.array([[5.0, 5.0]]))[0]
    assert masks.get(('LOG1', 7)) is None and 'LOG0' in masks._cache
    assert troi.build_roi_masks(FakeDataset(), str(tmp_path / 'none')) is None


def test_roi_gates_the_metric_like_jax(tmp_path):
    write_map_archive(str(tmp_path / 'map'), [SQUARE])
    polys = troi.load_drivable_polygons(str(tmp_path / 'map'))
    sweep = troi.SweepROI(troi.rasterize_roi(polys), np.eye(4))
    jsweep = jroi.SweepROI(jroi.rasterize_roi(polys), np.eye(4))

    def box(x, y):
        return [x, y, 1.0, 2.0, 2.0, 2.0, 0.0]

    dets = [dict(log_id='LOG0', timestamp_ns=1,
                 boxes=np.array([box(10, 10), box(60, 60)], np.float32),
                 scores=np.array([0.9, 0.9], np.float32),
                 labels=np.array([0, 0]))]
    anns = [dict(log_id='LOG0', timestamp_ns=1,
                 boxes=np.array([box(10, 10), box(60, 60)], np.float32),
                 labels=np.array([0, 0]),
                 num_interior_pts=np.array([5, 5]))]
    s_roi, m_roi = evaluate_detections(
        dets, anns, DetectionConfig(categories=('ARTICULATED_BUS',)),
        workers=0, roi_masks={('LOG0', 1): sweep})
    js_roi, jm_roi = jax_evaluate(
        dets, anns, JaxDetectionConfig(categories=('ARTICULATED_BUS',)),
        workers=0, roi_masks={('LOG0', 1): jsweep})
    assert s_roi['ARTICULATED_BUS']['num_gts'] == 1 == \
        js_roi['ARTICULATED_BUS']['num_gts']
    assert m_roi['mAP'] == jm_roi['mAP'] and m_roi['mAP'] > 0.9


# ----------------------------------------------------------- the submission
def _results(seed, frames=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(frames):
        n = rng.randint(0, 6) if i else 4
        out.append(dict(index=i, log_id=f'log{i % 2}',
                        timestamp_ns=int(1.5e17) + i * 10**8,
                        boxes=rng.randn(n, 7).astype(np.float32) * 10,
                        scores=rng.rand(n).astype(np.float32),
                        labels=rng.randint(0, 26, n)))
    return out


def test_submission_feather_reads_back_as_jax_frame(tmp_path):
    results = _results(0)
    names = tcfg.AV2_CLASS_NAMES
    path = str(tmp_path / 'sub.feather')
    rows = write_feather(path, port_eval.format_av2_submission(results, names))
    want = jax_eval.format_av2_submission(results, names)
    assert rows == len(want) == num_rows(path) > 0
    got = pd.read_feather(path)
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_feather_num_rows_reads_pandas_files(tmp_path):
    path = str(tmp_path / 'pd.feather')
    pd.DataFrame({'a': np.arange(7), 'b': list('abcdefg')}).to_feather(path)
    assert num_rows(path) == 7


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope='module')
def cli_fixture(tmp_path_factory):
    """2 scenes x 3 frames x 2 cameras of PNG, a map per scene, and a
    checkpoint of the tiny model."""
    root = tmp_path_factory.mktemp('serve')
    ann = root / 'infos.pkl'
    make_fake_infos(ann, n_scenes=2, frames_per_scene=3, n_cams=2)
    with open(ann, 'rb') as f:
        infos = pickle.load(f)['infos']
    rng = np.random.RandomState(0)
    for info in infos:
        for cam in info['cam_infos'].values():
            cam['fpath'] = cam['fpath'].replace('.jpg', '.png')
            path = root / cam['fpath']
            path.parent.mkdir(parents=True, exist_ok=True)
            write_png(str(path), rng.randint(0, 256, (128, 192, 3)
                                             ).astype(np.uint8))
    with open(ann, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    for scene in ('scene0', 'scene1'):
        write_map_archive(str(root / scene / 'map'),
                          [[(-20.0, -20.0), (20.0, -20.0), (20.0, 5.0),
                            (-20.0, 5.0)]], log_id=scene)
    cfg = tcfg.tiny_test_config()
    state, _ = create_train_state(cfg, build_model(cfg, 'cpu', seed=3))
    CheckpointManager(str(root / 'ckpt')).save(1, state, force=True)
    return root


def test_cli_test_quant_map_root_submission(cli_fixture, tmp_path, capsys):
    from far3d_tpu_torch.cli import test as cli
    root = cli_fixture
    base = ['--data-root', str(root), '--ann-file', str(root / 'infos.pkl'),
            '--checkpoint', str(root / 'ckpt'), '--tiny', '--device', 'cpu',
            '--results-dir', str(tmp_path / 'res')]
    sub = str(tmp_path / 'sub.feather')
    out = cli.evaluate(base + ['--quant', '--quant-calib-frames', '2',
                               '--map-root', str(root), '--submission', sub])
    printed = capsys.readouterr().out
    assert 'HD-map ROI gate: enabled' in printed
    assert 'int8 PTQ backbone: calibrated on 2 frames' in printed
    assert out['frames'] == 6
    assert all(np.isfinite(v) for v in out['means'].values())
    assert out['submission_rows'] == num_rows(sub)
    frame = pd.read_feather(sub)
    assert len(frame) == out['submission_rows']
    assert set(frame['log_id']) <= {'scene0', 'scene1'}
    assert cli.main(base) == 0
