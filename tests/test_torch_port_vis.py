"""The port's drawing (``utils/vis.py`` and the rasterizers of
``data/image_io.py``), ``models/second_fpn.py`` and the decoder's captured
sampling against OpenCV and the JAX package, on the CPU.

* Geometry exactly: ``box_corners``, the endpoints of every projected edge,
  the BEV polygons, the score labels' strings and anchors are the JAX
  module's (OpenCV's calls recorded on the JAX side).
* ``cv2.rectangle`` (``LINE_8``), ``cv2.resize`` (``INTER_LINEAR`` and
  ``INTER_NEAREST``) and ``cv2.clipLine`` bit for bit; the ``LINE_AA`` lines
  and dots by their masks: every pixel the port changes lies within 1 px of
  one OpenCV changes, and the other way round. The score text is the port's
  own stroke font (string and anchor held, pixels not).
* ``SECONDFPN`` on converted weights and the decoder's captured ``loc`` and
  ``w`` against the JAX module and its sown intermediates at rtol 1e-3,
  atol 2e-3.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import far3d_tpu.utils.vis as jvis
import far3d_tpu_torch.utils.vis as tvis
from _torch_port_setup import TOL, make_cfgs, port_model, shared_weights
from far3d_tpu.models.detector import Far3D as JaxFar3D
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.models.second_fpn import SECONDFPN as JaxSECONDFPN
from far3d_tpu_torch.data import image_io
from far3d_tpu_torch.models.decoder import capture_sampling
from far3d_tpu_torch.models.farhead import init_state as torch_init_state
from far3d_tpu_torch.models.second_fpn import SECONDFPN
from far3d_tpu_torch.utils.convert import second_fpn_from_jax_variables
from far3d_tpu_torch.utils.synthetic import ring_cameras


def _within_one_pixel(a, b):
    """Every True of `a` has a True of `b` in its 3x3 neighbourhood."""
    p = np.pad(b, 1)
    near = np.zeros_like(b)
    for dy in range(3):
        for dx in range(3):
            near |= p[dy:dy + b.shape[0], dx:dx + b.shape[1]]
    return bool((a <= near).all())


def _masks_agree(want, got, base):
    mw, mg = (want != base).any(-1), (got != base).any(-1)
    return _within_one_pixel(mg, mw) and _within_one_pixel(mw, mg)


def _boxes(rng, n):
    return np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                     rng.uniform(-1, 2, n), rng.uniform(1, 6, n),
                     rng.uniform(1, 3, n), rng.uniform(1, 3, n),
                     rng.uniform(-np.pi, np.pi, n)], 1)


def test_box_corners_are_jaxs():
    rng = np.random.default_rng(0)
    for b in _boxes(rng, 20):
        np.testing.assert_array_equal(tvis.box_corners(b),
                                      jvis.box_corners(b))


def _record(monkeypatch, module, name):
    calls = []
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(a))
    return calls


def test_camera_edges_and_bev_polygons_are_jaxs(monkeypatch):
    """The endpoints of every drawn edge and every BEV polygon, as the JAX
    module hands them to OpenCV."""
    rng = np.random.default_rng(1)
    intr, extr = ring_cameras(3, 64, 96)
    boxes = _boxes(rng, 12)
    for ci in range(3):
        l2i = intr[ci] @ extr[ci]
        img = np.zeros((64, 96, 3), np.uint8)
        with monkeypatch.context() as m:
            want = _record(m, cv2, 'line')
            jvis.draw_boxes_camera(img, boxes, l2i)
        with monkeypatch.context() as m:
            got = _record(m, tvis, 'draw_line_aa')
            tvis.draw_boxes_camera(img, boxes, l2i)
        assert want and [a[1:3] for a in got] == [a[1:3] for a in want]
        assert all(a[3] == tvis.PRED_COLOR for a in got)
    with monkeypatch.context() as m:
        want = _record(m, cv2, 'polylines')
        wc = _record(m, cv2, 'circle')
        jvis.draw_bev(boxes[:5], boxes[5:], extent=30.0, size=128)
    with monkeypatch.context() as m:
        got = _record(m, tvis, 'draw_polyline_aa')
        gc = _record(m, tvis, 'fill_circle')
        tvis.draw_bev(boxes[:5], boxes[5:], extent=30.0, size=128)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1][0])
        assert g[2] == w[3]
    assert gc[0][1:3] == wc[0][1:3]


def test_score_labels_are_jaxs(monkeypatch):
    rng = np.random.default_rng(2)
    xy = rng.uniform(-5, 80, (10, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (10, 2))], 1)
    scores = rng.uniform(0, 1, 10)
    img = np.zeros((64, 96, 3), np.uint8)
    with monkeypatch.context() as m:
        want = _record(m, cv2, 'putText')
        m.setattr(cv2, 'rectangle', lambda *a, **k: None)
        jvis.draw_boxes_2d(img, boxes, scores=scores)
    with monkeypatch.context() as m:
        got = _record(m, tvis, 'draw_text')
        tvis.draw_boxes_2d(img.copy(), boxes, scores=scores)
    assert [a[1:3] for a in got] == [a[1:3] for a in want]
    drawn = img.copy()
    image_io.draw_text(drawn, '0.57', (20, 30), (255, 255, 255))
    assert drawn[20:31, 20:45].any() and not drawn[31:].any()


def test_drawn_images_against_opencv():
    """Whole JAX drawings (OpenCV) against the port's: rectangles and the
    BEV's ego dot bit for bit, the anti-aliased strokes by their masks."""
    rng = np.random.default_rng(3)
    intr, extr = ring_cameras(2, 96, 128)
    boxes = _boxes(rng, 10)
    base = np.full((96, 128, 3), 20, np.uint8)
    for ci in range(2):
        l2i = intr[ci] @ extr[ci]
        want = jvis.draw_boxes_camera(base.copy(), boxes, l2i)
        got = tvis.draw_boxes_camera(base.copy(), boxes, l2i)
        assert (want != base).any() and _masks_agree(want, got, base)
    bw, bg = jvis.draw_bev(boxes[:4], boxes[4:], 30.0, 160), \
        tvis.draw_bev(boxes[:4], boxes[4:], 30.0, 160)
    assert _masks_agree(bw, bg, np.full_like(bw, 30))
    xy = rng.uniform(-10, 110, (8, 2))
    rects = np.concatenate([xy, xy + rng.uniform(-20, 40, (8, 2))], 1)
    np.testing.assert_array_equal(jvis.draw_boxes_2d(base.copy(), rects),
                                  tvis.draw_boxes_2d(base.copy(), rects))
    uv = rng.uniform(-5, 130, (20, 2))
    colors = rng.integers(0, 256, (20, 3))
    for kw in ({}, {'colors': colors, 'radius': 3}):
        want = jvis.draw_points(base.copy(), uv, **kw)
        got = tvis.draw_points(base.copy(), uv, **kw)
        assert _masks_agree(want, got, base)


@pytest.mark.parametrize('color', [(255, 255, 255), (80, 200, 80)])
def test_rasterizers_against_opencv(color):
    rng = np.random.default_rng(4)
    for _ in range(300):
        h, w = int(rng.integers(5, 120)), int(rng.integers(5, 160))
        base = np.full((h, w, 3), 0 if color[0] == 255 else 40, np.uint8)
        p0 = tuple(int(v) for v in rng.integers(-300, 400, 2))
        p1 = tuple(int(v) for v in rng.integers(-300, 400, 2))
        inside, c0, c1 = cv2.clipLine((0, 0, w, h), p0, p1)
        got = image_io.clip_line((w, h), p0, p1)
        assert got[0] == bool(inside)
        if inside:
            assert got[1:] == (tuple(c0), tuple(c1))
        want, got = base.copy(), base.copy()
        cv2.line(want, p0, p1, color, 1, cv2.LINE_AA)
        image_io.draw_line_aa(got, p0, p1, color)
        assert _masks_agree(want, got, base), (h, w, p0, p1)
        want, got = base.copy(), base.copy()
        cv2.rectangle(want, p0, p1, color, 1)
        image_io.draw_rectangle(got, p0, p1, color)
        np.testing.assert_array_equal(got, want)
        c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        r = int(rng.integers(0, 6))
        want, got = base.copy(), base.copy()
        cv2.circle(want, c, r, color, -1, cv2.LINE_AA)
        image_io.fill_circle_aa(got, c, r, color)
        assert _masks_agree(want, got, base), (h, w, c, r)


@pytest.mark.parametrize('src,dst', [
    ((1550, 2048), (303, 400)), ((2048, 1550), (528, 400)),
    ((640, 960), (267, 400)), ((800, 800), (450, 450)), ((20, 30), (41, 67)),
    ((100, 50), (50, 25)), ((1, 7), (3, 2)), ((37, 53), (37, 53))])
def test_resize_is_opencvs(src, dst):
    img = np.random.default_rng(5).integers(0, 256, src + (3,), np.uint8)
    w, h = dst[1], dst[0]
    np.testing.assert_array_equal(image_io.resize_linear(img, (w, h)),
                                  cv2.resize(img, (w, h)))
    np.testing.assert_array_equal(
        image_io.resize_nearest(img, (w, h)),
        cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


def test_compose_camera_grid_is_jaxs():
    """The grid of an AV2-style rig (one portrait camera among landscape
    ones, so both the crop and the majority tile height are exercised) with
    a BEV panel, bit for bit."""
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (205, 155, 3), np.uint8)] + \
        [rng.integers(0, 256, (155, 205, 3), np.uint8) for _ in range(4)] + \
        [rng.integers(0, 256, (100, 205, 3), np.uint8)]
    bev = rng.integers(0, 256, (160, 160, 3), np.uint8)
    np.testing.assert_array_equal(
        tvis.compose_camera_grid(images, cols=3, tile_w=120, bev=bev),
        jvis.compose_camera_grid(images, cols=3, tile_w=120, bev=bev))


def test_denormalize_and_depth_color_are_jaxs():
    mean, std = (103.5, 116.3, 123.7), (57.4, 57.1, 58.4)
    x = np.random.RandomState(0).standard_normal((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.denormalize_image(x, mean, std),
                                  jvis.denormalize_image(x, mean, std))
    d = np.linspace(-5, 80, 50)
    np.testing.assert_array_equal(tvis.depth_color(d, 60.0),
                                  jvis.depth_color(d, 60.0))


@pytest.mark.parametrize('final_dim,no_stride_conv', [(10, False),
                                                      (None, True)])
def test_second_fpn_against_jax(final_dim, no_stride_conv):
    rng = np.random.default_rng(7)
    kw = dict(in_channels=(8, 12, 16), out_channels=(8, 8, 8),
              upsample_strides=(0.5, 1, 2),
              use_conv_for_no_stride=no_stride_conv,
              final_conv_feature_dim=final_dim)
    xs = [rng.standard_normal((2, h, w, c)).astype(np.float32)
          for (h, w), c in zip([(16, 12), (8, 6), (4, 3)], (8, 12, 16))]
    jmod = JaxSECONDFPN(**kw)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                   [jnp.asarray(x) for x in xs])
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(-0.3, 0.3, v.shape).astype(
            np.float32) * (np.abs(np.asarray(v)).max() + 0.5), variables)
    variables['stats'] = jax.tree_util.tree_map(np.abs, variables['stats'])
    want = jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                      [jnp.asarray(x) for x in xs])[0]
    model = SECONDFPN(**kw).eval()
    missing, unexpected = model.load_state_dict(second_fpn_from_jax_variables(
        variables, kw['upsample_strides'], no_stride_conv), strict=True)
    with torch.no_grad():
        got = model([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])[0]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def test_decoder_capture_matches_jax_intermediates():
    """Each decoder layer's sampling locations and attention weights, as
    the port's capture hands them out and as the JAX module sows them, on
    shared weights; outside ``capture_sampling`` nothing is recorded."""
    jax_cfg, port_cfg = make_cfgs()
    jax_cfg = jax_cfg.replace(decoder=dataclasses.replace(jax_cfg.decoder,
                                                          remat=False))
    variables, sd = shared_weights(jax_cfg, port_cfg)
    model = port_model(port_cfg, sd)
    rng = np.random.default_rng(8)
    n, (h, w) = jax_cfg.data.num_cams, jax_cfg.data.input_hw
    intr, extr = ring_cameras(n, h, w)
    frame = dict(
        images=(rng.standard_normal((1, n, h, w, 3)) * 0.5).astype(np.float32),
        lidar2img=np.einsum('nij,njk->nik', intr, extr).astype(
            np.float32)[None],
        intrinsics=intr[None], extrinsics=extr[None],
        prev_exists=np.float32([0.0]), timestamp=np.float32([1.0]),
        ego_pose=np.eye(4, dtype=np.float32)[None],
        ego_pose_inv=np.eye(4, dtype=np.float32)[None])
    out, mods = JaxFar3D(jax_cfg).apply(
        variables, state=jax_init_state(1, jax_cfg.head),
        mutable=['intermediates'],
        **{k: jnp.asarray(v) for k, v in frame.items()})
    inter = mods['intermediates']['pts_head']['decoder']
    tframe = {k: torch.from_numpy(v) for k, v in frame.items()}
    with torch.no_grad(), capture_sampling(model) as layers:
        got = model(state=torch_init_state(1, port_cfg.head, 'cpu'), **tframe)
    assert len(layers) == jax_cfg.decoder.num_layers
    # the learned queries (the 2D proposals' order can differ on ties)
    nq = jax_cfg.head.num_query
    np.testing.assert_allclose(got['all_cls_scores'][-1, :, :nq].numpy(),
                               np.asarray(out['all_cls_scores'])[-1, :, :nq],
                               **TOL)
    for li, calls in enumerate(layers):
        assert len(calls) == 1
        agg = inter[f'layer{li}']['cross_attn']
        for name in ('sampling_loc', 'attn_weights'):
            want = np.asarray(agg[name][0])[:, :nq]
            have = calls[0][name][:, :nq].numpy()
            assert have.shape == want.shape, name
            np.testing.assert_allclose(have, want, err_msg=f'{li} {name}',
                                       **TOL)
    assert all(m.capture is None for m in model.modules()
               if hasattr(m, 'capture'))
