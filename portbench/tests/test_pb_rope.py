"""The ViT's rotation of q and k counter of ``harness/rope.py`` against a
hand count, and ``vit_rope_roofline`` on hand-laid traces."""

import dataclasses
import types

import pytest

import pb_tiny
from harness import rope, spec, work
from harness.trace import Trace

CONFIG = 'streampetr_vitl_nusc'


def _cell_backbone():
    return spec.load_json(pb_tiny.BENCH / 'configs'
                          / f'{CONFIG}.json')['model']['backbone']


def test_the_cells_rotations_move_7_60_gb_a_frame():
    vit = _cell_backbone()
    hw = (800, 1600)
    # q and k, 2,048 channels a token, read and written in bf16; a windowed
    # block takes 6 cameras of 50 x 100 tokens padded to 64 x 112, a global
    # block the real grid
    assert vit['global_blocks'][0] == 2
    assert rope.block_bytes(vit, 6, hw, 0) == 6 * 64 * 112 * 2048 * 2 * 2 \
        == 352_321_536
    assert rope.block_bytes(vit, 6, hw, 2) == 30000 * 2048 * 2 * 2 \
        == 245_760_000
    assert rope.frame_bytes(vit, 6, hw) == 16 * 352_321_536 \
        + 8 * 245_760_000 == 7_603_224_576
    least = rope.least_seconds(vit, 6, hw)
    assert least == pytest.approx(7_603_224_576 / 3.35e12)
    assert least == pytest.approx(2.2696e-3, rel=1e-4)


def test_the_tiny_rotations_are_the_same_sum():
    from far3d_tpu_torch.models.streampetr_vit import tiny_vit_petr_config
    cfg = tiny_vit_petr_config()
    vit = dataclasses.asdict(cfg.backbone)
    # 2 cameras of 4 x 6 tokens, 4 x 4 windows (padded to 4 x 8), 64 wide;
    # blocks 0 and 1 windowed, block 2 global
    assert (cfg.num_cams, cfg.input_hw, vit['depth']) == (2, (64, 96), 3)
    assert (vit['window_size'], vit['embed_dim'],
            tuple(vit['global_blocks'])) == (4, 64, (2,))
    assert rope.block_bytes(vit, 2, (64, 96), 0) == 2 * 4 * 8 * 128 * 4
    assert rope.block_bytes(vit, 2, (64, 96), 2) == 2 * 4 * 6 * 128 * 4
    assert rope.frame_bytes(vit, 2, (64, 96)) == 2 * 32768 + 24576
    assert rope.least_seconds(vit, 2, (64, 96)) == \
        work.bound_seconds(90112, 0, 1.0)


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
    read = spec.metric_reader('vit_rope_roofline')
    name = ('void (anonymous namespace)::vit_rope_kernel<__nv_bfloat16>'
            '(__nv_bfloat16 const*, __nv_bfloat16 const*, '
            '__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, '
            'long long, long long, long long, long long)')
    # two frames' rotations take 6 ms of device time inside the backbone;
    # one launched under the heads' label is left out
    ctx = _ctx([(100, 3_000_100, name, 'kernel', 1),
                (3_000_200, 6_000_200, name, 'kernel', 2),
                (6_000_300, 6_000_400, name, 'kernel', 3)],
               {1: 10, 2: 20, 3: 2500})
    least = 2 * 7_603_224_576 / 3.35e12
    assert read(ctx) == pytest.approx(100 * least / 6e-3)


def test_the_roofline_reads_nothing_without_the_kernel():
    read = spec.metric_reader('vit_rope_roofline')
    ctx = _ctx([(100, 200, 'elementwise_kernel_128_4', 'kernel', 1),
                (300, 400, 'index_elementwise_kernel', 'kernel', 2)],
               {1: 10, 2: 20})
    assert read(ctx) is None
