"""StreamPETR with the EVA-02 ViT backbone (``models/vit.py``,
``models/streampetr_vit.py``) on the CPU at a tiny size, against the
benchmark's plain reference (``portbench/reference/models/vit.py`` and
``streampetr_vit.py``) on the same seeded random weights, in float32.

The tiny ViT is 64 wide with 4 heads, three blocks (windowed, windowed,
global) and 4 x 4 windows; a 64 x 96 image makes a 4 x 6 patch grid, padded
to 4 x 8 in the windowed blocks, and a rectangular grid in the global one.

Tolerances: the two sides run the same float32 arithmetic in another
order (``scaled_dot_product_attention`` against explicit matmuls and
softmax, the rotation by swapped pairs against EVA-02's ``rotate_half``,
the SwiGLU's padded hidden width), so they agree to float32 rounding grown
through a few layers: ``REL`` (1e-5) on the backbone's map by its norm,
and ``assert_close``'s 1e-4 on a frame's detections and memory, as the
benchmark's test of the other families. The two planted faults (RoPE left
out, the padded keys masked) move the map by 1e-1 or more.
"""

import collections
import dataclasses
import pathlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from far3d_tpu_torch.models import vit
from far3d_tpu_torch.models.streampetr import init_petr_state
from far3d_tpu_torch.models.streampetr_vit import (StreamPETRViT,
                                                   tiny_vit_petr_config)
from far3d_tpu_torch.train.petr_step import make_petr_infer_step
from far3d_tpu_torch.utils.synthetic import petr_inference_inputs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / 'portbench'))
from harness import spec  # noqa: E402
from harness.weights import seeded_weights, state_shapes  # noqa: E402
from reference.models import detector as ref_detector  # noqa: E402
from reference.models import streampetr as ref_streampetr  # noqa: E402
from reference.models import streampetr_vit as ref_vit  # noqa: E402

REL = 1e-5
SEED = 2 ** 31 + 5


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope='module')
def models():
    """(config, port model, reference model) on the same weights."""
    cfg = tiny_vit_petr_config()
    weights = seeded_weights(state_shapes(StreamPETRViT, cfg), SEED, 'cpu')
    ref_cfg = spec.build_dataclass(ref_vit.StreamPETRViTConfig,
                                   dataclasses.asdict(cfg))
    port = StreamPETRViT(cfg)
    port.load_state_dict(weights)
    ref = ref_vit.StreamPETRViT(ref_cfg)
    ref.load_state_dict(weights)
    return cfg, port.eval(), ref.eval()


def _images(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(cfg.num_cams, 3, *cfg.input_hw, generator=gen)


def test_the_state_dict_keys_are_the_references(models):
    _, port, ref = models
    assert list(port.state_dict()) == list(ref.state_dict())
    keys = list(port.state_dict())
    for name in ('img_backbone.patch_embed.proj.weight',
                 'img_backbone.pos_embed',
                 'img_backbone.blocks.2.attn.qkv.weight',
                 'img_backbone.blocks.2.attn.q_bias',
                 'img_backbone.blocks.2.attn.v_bias',
                 'img_backbone.blocks.2.attn.inner_attn_ln.weight',
                 'img_backbone.blocks.2.mlp.ffn_ln.bias',
                 'img_neck.lateral_convs.0.conv.bias',
                 'img_neck.fpn_convs.0.conv.weight'):
        assert name in keys, name
    assert 'img_backbone.blocks.0.attn.k_bias' not in keys
    assert not any('qkv.bias' in k or 'rope' in k for k in keys)


@torch.no_grad()
def test_the_backbone_is_the_references(models):
    _, port, ref = models
    x = _images(models[0])
    got, want = port.img_backbone(x), ref.img_backbone(x)
    assert got.shape == want.shape == (2, 64, 4, 6)
    assert _rel(got, want) < REL


def _no_rope(x, cos, sin):
    return x


def _masked_padding(q, k, v):
    # a padded key's k is exactly zero (zero input, no k bias)
    keep = (k != 0).any(-1)[..., None, :]
    return torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            attn_mask=keep)


@pytest.mark.parametrize('name,fault', [('rope', _no_rope),
                                        ('attention', _masked_padding)])
@torch.no_grad()
def test_a_planted_fault_fails_the_tolerance(models, monkeypatch, name,
                                             fault):
    _, port, ref = models
    x = _images(models[0])
    monkeypatch.setattr(vit, name, fault)
    assert _rel(port.img_backbone(x), ref.img_backbone(x)) > 1000 * REL


@torch.no_grad()
def test_new_weights_reach_the_kept_position_table(models):
    """The resized position table is kept per loaded table: loading other
    weights in place resizes it again."""
    cfg, port, ref = models
    x = _images(cfg)
    port.img_backbone(x)
    other = seeded_weights(state_shapes(StreamPETRViT, cfg), SEED + 1, 'cpu')
    try:
        port.load_state_dict(other)
        ref.load_state_dict(other)
        assert _rel(port.img_backbone(x), ref.img_backbone(x)) < REL
    finally:
        restore = seeded_weights(state_shapes(StreamPETRViT, cfg), SEED,
                                 'cpu')
        port.load_state_dict(restore)
        ref.load_state_dict(restore)


def _batch(cfg, i):
    inputs = {k: torch.from_numpy(v)
              for k, v in petr_inference_inputs(cfg, 1, seed=i).items()}
    inputs['prev_exists'] = torch.full((1,), float(i > 0))
    inputs['timestamp'] = torch.full((1,), 0.5 * i)
    return inputs


def test_a_streamed_frame_is_the_references(models):
    """Two frames through ``make_petr_infer_step`` (the second carrying the
    first's memory) against the reference model and its decode."""
    cfg, port, ref = models
    step = make_petr_infer_step(cfg)
    p_state = init_petr_state(1, cfg)
    r_state = ref_streampetr.init_petr_state(1, cfg)
    for i in range(2):
        batch = _batch(cfg, i)
        dets, p_state = step(port, p_state, batch)
        with torch.inference_mode():
            out = ref(state=r_state, **batch)
        want = ref_detector.decode_boxes(
            out['all_cls_scores'][-1], out['all_bbox_preds'][-1],
            out['query_valid'], cfg.max_decode_num, cfg.post_center_range)
        r_state = out['state']
        for k in ('boxes', 'scores'):
            torch.testing.assert_close(dets[k], want[k], rtol=1e-4,
                                       atol=1e-4)
        for k in ('labels', 'valid', 'query_idx'):
            assert torch.equal(dets[k], want[k]), (i, k)
        for k in ('embedding', 'ref_points', 'timestamp', 'egopose', 'velo'):
            torch.testing.assert_close(getattr(p_state, k),
                                       getattr(r_state, k), rtol=1e-4,
                                       atol=1e-4)
    assert step.eager_frames == 2


def test_an_eager_frame_labels_the_backbones_blocks(models):
    cfg, port, _ = models
    step = make_petr_infer_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(port, init_petr_state(1, cfg), _batch(cfg, 0))
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()
             and e.name().startswith(('serve.', 'model.'))]
    counts = collections.Counter(name for name, *_ in spans)
    assert counts == {'serve.step': 1, 'serve.decode': 1,
                      'model.backbone': 1, 'model.backbone.patch': 1,
                      'model.backbone.window': 2, 'model.backbone.global': 1,
                      'model.neck': 1, 'model.queries': 1,
                      'model.decoder': 1,
                      'model.decoder.layer': cfg.num_layers,
                      'model.branches': 1, 'model.memory': 1}
    (backbone,) = [s for s in spans if s[0] == 'model.backbone']
    inner = [s for s in spans if s[0].startswith('model.backbone.')]
    assert all(backbone[1] <= s[1] and s[2] <= backbone[2] for s in inner)
    inner.sort(key=lambda s: s[1])
    assert [s[0] for s in inner] == ['model.backbone.patch',
                                     'model.backbone.window',
                                     'model.backbone.window',
                                     'model.backbone.global']
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_the_int8_backbone_refuses_a_vit_by_name(models):
    from far3d_tpu_torch.ops.quant import quantize_petr_backbone
    cfg, port, _ = models
    with pytest.raises(TypeError, match='ViT backbone, which has no int8'):
        quantize_petr_backbone(port, [torch.zeros(
            1, cfg.num_cams, *cfg.input_hw, 3, dtype=torch.uint8)])
    with pytest.raises(ValueError, match='no int8 backbone'):
        port.forward_towers(torch.zeros(1, cfg.num_cams, *cfg.input_hw, 3),
                            quant_backbone={})
