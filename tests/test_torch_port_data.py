"""The port's host data path against the JAX package's, on the CPU.

* ``data/image_io.py``: the PNG writer and reader round-trip bitwise and
  OpenCV reads the port's PNG to the same array; the reader decodes Sub,
  Up, Average and Paeth rows, and OpenCV's adaptively filtered files, as
  ``cv2.imread`` does; ``fill_circle`` is ``cv2.circle``
  pixel for pixel; ``warp_affine_inverse`` is ``cv2.warpAffine(INTER_LINEAR
  | WARP_INVERSE_MAP, BORDER_CONSTANT, 0)`` within WARP_TOL on native AV2
  sources (random uint8) at the pipeline's resize scales and the front
  camera's pre-rotation.
* ``data/pipeline.py``: ``process_frame`` of both packages on the same
  record, images and seeded Generator, train and eval: the images within
  WARP_TOL, every other output equal.
* ``data/av2_dataset.py``, ``sampler.py``, ``loader.py``: identical records
  and index streams, and the same batches key by key from both packages'
  loaders over one PNG dataset on disk.
* ``utils/synthetic.py``'s learnable dataset writers: the same infos as the
  JAX writers (paths aside: .png for .jpg), images within 8 levels at every
  GT's centre (JPEG's error).
* ``eval/av2_metrics.py``: equal results on tests/test_eval_metrics.py's
  cases.
"""

import dataclasses
import itertools
import pickle
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

import far3d_tpu.config as jcfg
import far3d_tpu_torch.config as tcfg
from far3d_tpu.data import av2_dataset as jds
from far3d_tpu.data import loader as jloader
from far3d_tpu.data import pipeline as jpipe
from far3d_tpu.data import sampler as jsampler
from far3d_tpu.eval import av2_metrics as jmetrics
from far3d_tpu.utils import synthetic as jsynth
from far3d_tpu_torch.data import av2_dataset as tds
from far3d_tpu_torch.data import image_io
from far3d_tpu_torch.data import loader as tloader
from far3d_tpu_torch.data import pipeline as tpipe
from far3d_tpu_torch.data import sampler as tsampler
from far3d_tpu_torch.eval import av2_metrics as tmetrics
from far3d_tpu_torch.utils import synthetic as tsynth
from test_data import make_fake_infos

# The float32 warp against OpenCV's: at most 1 uint8 level apart, on at most
# 1% of the pixels (measured: at most 0.3% at these scales).
WARP_TOL = dict(max_level=1, max_share=0.01)
# JPEG (the JAX writer, default quality) against PNG at a blob's centre.
JPEG_LEVELS = 8


def assert_warp_close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert d.max() <= WARP_TOL['max_level'], d.max()
    assert (d > 0).mean() <= WARP_TOL['max_share'], (d > 0).mean()


# ---------------------------------------------------------------- image I/O
def test_png_round_trip_and_cv2_reads_it(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / 'a.png')
    image_io.write_png(path, img)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    np.testing.assert_array_equal(image_io.read_image(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)


def _png_with_filters(rgb, filters):
    """A PNG of `rgb` whose row r is stored with filter type filters[r]
    (0-4, encoded as the PNG specification defines them)."""
    h, w, _ = rgb.shape
    raw = rgb.reshape(h, 3 * w).astype(np.int16)
    rows = []
    for r, f in enumerate(filters):
        a = np.concatenate([np.zeros(3, np.int16), raw[r, :-3]])
        b = raw[r - 1] if r > 0 else np.zeros_like(raw[r])
        c = np.concatenate([np.zeros(3, np.int16), b[:-3]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2,
                4: np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))}[f]
        line = raw[r] - pred
        rows.append(bytes([f]) + (line % 256).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))

    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + chunk(b'IEND', b''))


def test_png_reader_decodes_sub_and_up_rows(tmp_path):
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    path = tmp_path / 'f.png'
    path.write_bytes(_png_with_filters(rgb, [2, 1, 2, 2, 0, 2, 1, 1, 2]))
    np.testing.assert_array_equal(image_io.read_png(str(path)),
                                  rgb[..., ::-1])
    np.testing.assert_array_equal(cv2.imread(str(path)), rgb[..., ::-1])


@pytest.mark.parametrize('ftype,name', [(3, 'Average'), (4, 'Paeth')])
def test_png_reader_refuses_average_and_paeth(tmp_path, ftype, name):
    """A file of Average rows and one of Paeth rows (the first row of each,
    then rows of the other types between them) decode to what
    ``cv2.imread`` reads, and to the image."""
    rng = np.random.RandomState(ftype)
    rgb = rng.randint(0, 256, (11, 13, 3)).astype(np.uint8)
    rgb[4:8] = np.arange(13 * 3).reshape(13, 3)[None] * 5 % 256  # smooth rows
    path = tmp_path / f'{name}.png'
    path.write_bytes(_png_with_filters(
        rgb, [ftype] * 5 + [0, 1, 2] + [ftype] * 3))
    want = cv2.imread(str(path))
    np.testing.assert_array_equal(want, rgb[..., ::-1])
    np.testing.assert_array_equal(image_io.read_png(str(path)), want)


@pytest.mark.parametrize('filters', ['ALL_FILTERS', 'FAST_FILTERS'])
def test_png_reader_decodes_cv2_adaptive_filters(tmp_path, filters):
    """PNG files that ``cv2.imwrite`` wrote with its adaptive row filters
    (every type in one file for ALL_FILTERS) decode equal to ``cv2.imread``
    on a camera-sized image with smooth and noisy regions."""
    rng = np.random.RandomState(5)
    img = np.clip(np.cumsum(rng.standard_normal((90, 160, 3)), axis=1) * 5
                  + 128, 0, 255).astype(np.uint8)
    img[30:50] = rng.randint(0, 256, (20, 160, 3))
    path = str(tmp_path / 'cv.png')
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER,
                            getattr(cv2, f'IMWRITE_PNG_{filters}')])
    data, pos, idat = open(path, 'rb').read(), 8, b''
    while pos < len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + length] if kind == b'IDAT' else b''
        pos += 12 + length
    types = set(np.frombuffer(zlib.decompress(idat), np.uint8)
                .reshape(90, 1 + 3 * 160)[:, 0].tolist())
    if filters == 'ALL_FILTERS':
        assert {3, 4} <= types, types
    np.testing.assert_array_equal(image_io.read_png(path), cv2.imread(path))
    np.testing.assert_array_equal(image_io.read_image(path), img)


def test_read_image_without_opencv_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='PNG'):
        image_io.read_image(str(tmp_path / 'a.jpg'))


def test_fill_circle_matches_cv2():
    rng = np.random.RandomState(2)
    for _ in range(200):
        want = np.full((60, 80, 3), 50, np.uint8)
        got = want.copy()
        center = (int(rng.randint(-30, 110)), int(rng.randint(-30, 90)))
        radius = int(rng.randint(0, 45))
        color = tuple(rng.uniform(-10, 300, 3))
        cv2.circle(want, center, radius, color, -1)
        image_io.fill_circle(got, center, radius, color)
        np.testing.assert_array_equal(got, want, err_msg=str((center, radius)))


def _warp_maps():
    """(source hw, 2x3 map) of the pipeline's resampling at native AV2
    sizes: resize 0.47 / 0.51 / 0.55 with a crop, landscape and portrait,
    and the front camera's pre-rotation composed with the training resize."""
    out = []
    for hw in ((1550, 2048), (2048, 1550)):
        for s in (0.47, 0.51, 0.55):
            dims = (int(hw[1] * s), int(hw[0] * s))
            crop = (31, dims[1] - 640, 31 + 960, dims[1])
            out.append((hw, jpipe._pix_map(hw, dims, crop)[:2]))
    h, w = 2048, 1550
    _, dims, crop = jpipe.sample_augmentation_front(h, w)
    pre = jpipe._pix_map((h, w), dims, crop)
    h2, w2 = crop[3] - crop[1], crop[2] - crop[0]
    _, dims2, crop2 = jpipe.sample_augmentation(
        np.random.default_rng(0), jcfg.DataConfig(), h2, w2, True)
    out.append(((h, w), (pre @ jpipe._pix_map((h2, w2), dims2, crop2))[:2]))
    return out


@pytest.mark.parametrize('case', range(7))
def test_warp_matches_cv2(case):
    hw, m = _warp_maps()[case]
    img = np.random.RandomState(case).randint(0, 256, (*hw, 3)).astype(np.uint8)
    want = cv2.warpAffine(img, m, (960, 640),
                          flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    assert_warp_close(image_io.warp_affine_inverse(img, m, (960, 640)), want)


# ----------------------------------------------------------------- pipeline
def _fullsize_record(tmp_path):
    """One frame of the full-size learnable dataset (7 cameras at native AV2
    size, portrait front), read by both packages' datasets."""
    ann = str(tmp_path / 'infos.pkl')
    tsynth.make_learnable_dataset_fullsize(ann, str(tmp_path), n_scenes=1,
                                           frames_per_scene=2)
    jrec = jds.AV2SequenceDataset(ann, str(tmp_path)).get_frame(1)
    trec = tds.AV2SequenceDataset(ann, str(tmp_path)).get_frame(1)
    return jrec, trec


def assert_frames_match(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k == 'images':
            assert_warp_close(np.asarray(g), np.asarray(w))
        elif isinstance(w, (np.ndarray, np.generic)):
            g = np.asarray(g)
            assert g.dtype == np.asarray(w).dtype, k
            if np.issubdtype(g.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize('train', [True, False])
def test_process_frame_matches_jax(tmp_path, train):
    jrec, trec = _fullsize_record(tmp_path)
    rng = np.random.RandomState(4)
    images = [rng.randint(0, 256, (2048, 1550, 3) if c == 0 else
                          (1550, 2048, 3)).astype(np.uint8) for c in range(7)]
    want = jpipe.process_frame(jrec, jcfg.Far3DConfig(),
                               np.random.default_rng(9), train, images)
    got = tpipe.process_frame(trec, tcfg.Far3DConfig(),
                              np.random.default_rng(9), train, images)
    assert want['gt_mask2d'].sum() > 0 and want['gt_depth_fg'].any()
    assert_frames_match(got, want)


# ------------------------------------------------- dataset, samplers, loaders
@pytest.fixture(scope='module')
def fake_infos(tmp_path_factory):
    path = tmp_path_factory.mktemp('infos') / 'infos.pkl'
    make_fake_infos(path)
    return str(path)


def _equal_records(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, list):
            assert len(got[k]) == len(w), k
            for a, b in zip(got[k], w):
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize('kw', [dict(seq_split_num=2),
                                dict(seq_split_num=1, interval_test=True),
                                dict(load_interval=2, test_mode=True)])
def test_dataset_records_match_jax(fake_infos, kw):
    jd = jds.AV2SequenceDataset(fake_infos, '/nonexistent', **kw)
    td = tds.AV2SequenceDataset(fake_infos, '/nonexistent', **kw)
    np.testing.assert_array_equal(td.flag, jd.flag)
    assert len(td) == len(jd)
    for i in range(len(jd)):
        _equal_records(td.get_frame(i), jd.get_frame(i))


def test_samplers_match_jax(fake_infos):
    flag = jds.AV2SequenceDataset(fake_infos, '/nonexistent').flag
    for rank, world in ((0, 1), (1, 2)):
        args = (flag, 3, rank, world, 5)
        ji = iter(jsampler.InfiniteGroupStreamSampler(*args))
        ti = iter(tsampler.InfiniteGroupStreamSampler(*args))
        assert [next(ti) for _ in range(20)] == [next(ji) for _ in range(20)]
        js = jsampler.EpochGroupSampler(*args)
        ts = tsampler.EpochGroupSampler(*args)
        for epoch in range(3):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(js) and len(ts) == len(js)
    for n, world in ((10, 3), (7, 2), (5, 1)):
        for rank in range(world):
            js = jsampler.EvalShardSampler(n, rank, world)
            ts = tsampler.EvalShardSampler(n, rank, world)
            assert list(ts) == list(js) and ts.pad == js.pad


@pytest.fixture(scope='module')
def png_dataset(tmp_path_factory):
    """make_fake_infos with its 2 cameras as random 128x192 PNG files."""
    root = tmp_path_factory.mktemp('png')
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
            image_io.write_png(str(path), rng.randint(
                0, 256, (128, 192, 3)).astype(np.uint8))
    with open(p, 'wb') as f:
        pickle.dump({'infos': infos}, f)
    return str(p), str(root)


def test_train_loader_matches_jax(png_dataset):
    ann, root = png_dataset
    jl = jloader.TrainLoader(jds.AV2SequenceDataset(ann, root),
                             jcfg.tiny_test_config(), 2, seed=3,
                             num_threads=2)
    tl = tloader.TrainLoader(tds.AV2SequenceDataset(ann, root),
                             tcfg.tiny_test_config(), 2, seed=3,
                             num_threads=2, device='cpu')
    try:
        pairs = list(itertools.islice(zip(iter(jl), iter(tl)), 5))
        for want, got in pairs:
            want = {f.name: getattr(want, f.name)
                    for f in dataclasses.fields(want)}
            assert set(got) == set(want)
            assert all(isinstance(v, torch.Tensor) for v in got.values())
            assert_frames_match({k: v.numpy() for k, v in got.items()}, want)
        # 5 batches of 2 lanes over groups of 3 frames cross group starts
        assert any(got['prev_exists'].min() == 0 for _, got in pairs[1:])
    finally:
        jl.stop()
        tl.stop()


def test_eval_loader_matches_jax(png_dataset):
    ann, root = png_dataset
    kw = dict(split='val', seq_split_num=1, interval_test=True)
    jl = jloader.EvalLoader(jds.AV2SequenceDataset(ann, root, **kw),
                            jcfg.tiny_test_config(), rank=1, world_size=4,
                            prefetch=2, num_threads=2)
    tl = tloader.EvalLoader(tds.AV2SequenceDataset(ann, root, **kw),
                            tcfg.tiny_test_config(), rank=1, world_size=4,
                            prefetch=2, num_threads=2, device='cpu')
    assert len(tl) == len(jl) and tl.pad == jl.pad
    frames = list(zip(tl, jl))
    assert len(frames) == len(jl)
    for got, want in frames:
        got = {k: v.numpy() if isinstance(v, torch.Tensor) else v
               for k, v in got.items()}
        assert_frames_match(got, want)


# ------------------------------------------------------------------ writers
@pytest.mark.parametrize('writer,kw', [
    ('make_learnable_dataset', {}),
    ('make_learnable_dataset_fullsize', dict(n_scenes=2, frames_per_scene=1))])
def test_learnable_dataset_writer_matches_jax(tmp_path, writer, kw):
    jroot, troot = tmp_path / 'jax', tmp_path / 'port'
    want = getattr(jsynth, writer)(str(jroot / 'i.pkl'), str(jroot), **kw)
    got = getattr(tsynth, writer)(str(troot / 'i.pkl'), str(troot), **kw)
    with open(troot / 'i.pkl', 'rb') as f:
        assert len(pickle.load(f)['infos']) == len(want)

    def same(a, b, path):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                same(a[k], b[k], f'{path}.{k}')
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f'{path}[{i}]')
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)
        elif path.endswith('.fpath'):
            assert a == b.replace('.jpg', '.png'), path
        else:
            assert a == b, path

    same(got, want, 'infos')
    checked = 0
    for info in want:
        for c, cam in enumerate(info['cam_infos'].values()):
            jimg = cv2.imread(str(jroot / cam['fpath']))
            timg = image_io.read_png(str(troot / cam['fpath'].replace(
                '.jpg', '.png')))
            for u, v in info['gt2d_infos']['centers2d'][c]:
                a = timg[int(round(v)), int(round(u))].astype(int)
                b = jimg[int(round(v)), int(round(u))].astype(int)
                assert np.abs(a - b).max() <= JPEG_LEVELS, (cam['fpath'], a, b)
                checked += 1
    assert checked > 0


# -------------------------------------------------------------- AV2 metrics
def _metric_cases():
    """The detections and annotations of tests/test_eval_metrics.py."""
    from test_eval_metrics import _frame
    box = lambda x: [x, 0.0, 1.0, 4.0, 2.0, 1.5, 0.0]
    b2 = np.array([[10, 0, 1, 4, 2, 1.5, 0.3], [-20, 5, 1, 4, 2, 1.5, -1.0]])
    cases = {
        'perfect': ([_frame('log0', 0, b2, [15, 15], scores=[0.9, 0.8])],
                    [_frame('log0', 0, b2, [15, 15], pts=[10, 10])], {}),
        'missed_and_fp': (
            [_frame('l', 0, [[11.5, 0, 1, 4, 2, 1.5, 0.0],
                             [80, 80, 1, 4, 2, 1.5, 0.0]], [15, 15],
                    scores=[0.9, 0.8])],
            [_frame('l', 0, [[10, 0, 1, 4, 2, 1.5, 0.0]], [15], pts=[5])], {}),
        'range_gate': ([_frame('l', 0, [[200, 0, 1, 4, 2, 1.5, 0.0]], [15],
                               scores=[0.9])],
                       [_frame('l', 0, [[200, 0, 1, 4, 2, 1.5, 0.0]], [15],
                               pts=[5])], {}),
    }
    grid = np.zeros((100, 100), bool)
    grid[:, 50:] = True
    ann = [dict(log_id='log0', timestamp_ns=0,
                boxes=np.asarray([box(10.0), box(20.0), box(-10.0)]),
                labels=np.asarray([0, 0, 0]), num_interior_pts=np.ones(3))]
    det = [dict(log_id='log0', timestamp_ns=0,
                boxes=np.asarray([box(10.0), box(20.0), box(-20.0)]),
                scores=np.asarray([0.9, 0.8, 0.95]),
                labels=np.asarray([0, 0, 0]))]
    cases['roi'] = (det, ann, dict(grid=grid))
    cases['no_roi'] = (det, ann, {})
    rng = np.random.RandomState(7)
    dts, gts = [], []
    for f in range(4):
        n, m = 12, 9
        boxes = np.concatenate([rng.uniform(-40, 40, (m, 2)),
                                rng.uniform(0, 2, (m, 1)),
                                rng.uniform(1, 4, (m, 3)),
                                rng.uniform(-3, 3, (m, 1))], axis=1)
        noisy = boxes[rng.randint(0, m, n)] + rng.randn(n, 7) * 0.3
        dts.append(dict(log_id='log0', timestamp_ns=f, boxes=noisy,
                        scores=rng.rand(n), labels=rng.randint(0, 3, n)))
        gts.append(dict(log_id='log0', timestamp_ns=f, boxes=boxes,
                        labels=rng.randint(0, 3, m),
                        num_interior_pts=np.full(m, 5)))
    cases['random'] = (dts, gts, {})
    cases['random_workers'] = (dts, gts, dict(workers=3))
    return cases


@pytest.mark.parametrize('name', sorted(_metric_cases()))
def test_av2_metrics_equal_jax(name):
    det, ann, opt = _metric_cases()[name]
    results = []
    for mod in (jmetrics, tmetrics):
        kw = {}
        if 'grid' in opt:
            kw['roi_masks'] = {'log0': mod.RasterROI(
                grid=opt['grid'], origin_xy=(-50.0, -50.0), resolution_m=1.0)}
            kw['cfg'] = mod.DetectionConfig(categories=('ARTICULATED_BUS',))
        elif name in ('roi', 'no_roi'):
            kw['cfg'] = mod.DetectionConfig(categories=('ARTICULATED_BUS',))
        results.append(mod.evaluate_detections(det, ann,
                                               workers=opt.get('workers', 0),
                                               **kw))
    (js, jm), (ts, tm) = results
    assert tm == jm
    assert ts == js
    assert tmetrics.format_summary(ts, tm) == jmetrics.format_summary(js, jm)
    x = np.random.RandomState(0).uniform(-7, 7, 50)
    np.testing.assert_array_equal(tmetrics.wrap_angles(x),
                                  jmetrics.wrap_angles(x))
    d = np.random.RandomState(1).uniform(0.5, 4, (50, 3))
    np.testing.assert_array_equal(tmetrics.iou_3d_axis_aligned(d, d[::-1]),
                                  jmetrics.iou_3d_axis_aligned(d, d[::-1]))


def test_warp_refuses_rotation_and_shear():
    img = np.zeros((8, 8, 3), np.uint8)
    for m in ([[1, 0.1, 0], [0, 1, 0]], [[1, 0, 0], [-0.2, 1, 0]]):
        with pytest.raises(ValueError, match='rotation'):
            image_io.warp_affine_inverse(img, np.asarray(m), (4, 4))
