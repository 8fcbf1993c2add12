"""The ViT's SwiGLU tail counter of ``harness/swiglu.py`` against a hand
count, and ``vit_swiglu_roofline`` on hand-laid traces."""

import dataclasses
import types

import pytest

import pb_tiny
from harness import spec, swiglu, work
from harness.trace import Trace

CONFIG = 'streampetr_vitl_nusc'


def _cell_backbone():
    return spec.load_json(pb_tiny.BENCH / 'configs'
                          / f'{CONFIG}.json')['model']['backbone']


def test_the_cells_tail_moves_491_8_mb_a_block_and_11_80_gb_a_frame():
    vit = _cell_backbone()
    # 6 cameras of 50 x 100 tokens; a and g of 2,730 channels read, w3's
    # 2,736-wide input written, 2 bytes each
    assert swiglu.block_bytes(vit, 6, (800, 1600)) == \
        30000 * (2 * 2730 + 2736) * 2 == 491_760_000
    assert swiglu.frame_bytes(vit, 6, (800, 1600)) == 24 * 491_760_000
    least = swiglu.least_seconds(vit, 6, (800, 1600))
    assert least == pytest.approx(11.80224e9 / 3.35e12)
    assert least / 24 == pytest.approx(0.1468e-3, rel=1e-3)


def test_the_tiny_tail_is_the_same_sum():
    from far3d_tpu_torch.models.streampetr_vit import tiny_vit_petr_config
    cfg = tiny_vit_petr_config()
    vit = dataclasses.asdict(cfg.backbone)
    # 2 cameras of 4 x 6 tokens; 170 channels padded to 176; 3 blocks
    assert (cfg.num_cams, cfg.input_hw, vit['depth']) == (2, (64, 96), 3)
    assert swiglu.block_bytes(vit, 2, (64, 96)) == 48 * (2 * 170 + 176) * 2
    assert swiglu.frame_bytes(vit, 2, (64, 96)) == 3 * 49536
    assert swiglu.least_seconds(vit, 2, (64, 96)) == \
        work.bound_seconds(3 * 49536, 0, 1.0)


def _ctx(ops, launch_at, frames=2):
    t = Trace([], (0, 10_000))
    t.ops = ops
    t.launch_at = launch_at
    t.labels = {'model.backbone': [(0, 1000)], 'model.queries': [(2000,
                                                                  3000)]}
    t._starts = {k: [s for s, _ in v] for k, v in t.labels.items()}
    return types.SimpleNamespace(
        traced={'trace': t, 'frames': frames}, backbone=_cell_backbone(),
        family=types.SimpleNamespace(num_cams=6, input_hw=(800, 1600)),
        kernels=spec.kernel_names)


def test_the_roofline_reads_the_kernels_launched_inside_the_backbone():
    read = spec.metric_reader('vit_swiglu_roofline')
    name = ('void (anonymous namespace)::swiglu_tail_kernel<__nv_bfloat16>'
            '(__nv_bfloat16 const*, __nv_bfloat16 const*, '
            '__nv_bfloat16 const*, __nv_bfloat16*, int, int, float)')
    # two frames' tails take 10 ms of device time inside the backbone; one
    # launched under the heads' label is left out
    ctx = _ctx([(100, 5_000_100, name, 'kernel', 1),
                (5_000_200, 10_000_200, name, 'kernel', 2),
                (10_000_300, 10_000_400, name, 'kernel', 3)],
               {1: 10, 2: 20, 3: 2500})
    least = 2 * 24 * 491_760_000 / 3.35e12
    assert read(ctx) == pytest.approx(100 * least / 10e-3)


def test_the_roofline_reads_nothing_without_the_kernel():
    read = spec.metric_reader('vit_swiglu_roofline')
    ctx = _ctx([(100, 200, 'vectorized_layer_norm_kernel', 'kernel', 1),
                (300, 400, 'RowwiseMomentsCUDAKernel', 'kernel', 2)],
               {1: 10, 2: 20})
    assert read(ctx) is None
