"""The cell ``streampetr_vitl_nusc.stream_bf16`` at a tiny configuration
of its family on the CPU: a whole run (``drivers/stream.py``), correct on
a sound run and not on its control; the configuration as both sides
build it; and the ViT attention counter of ``harness/vit.py`` against a
hand count."""

import dataclasses
import json
import time

import pytest

import pb_tiny
from harness import compare, family, spec, vit, work

CELL = 'streampetr_vitl_nusc.stream_bf16'
CONFIG = 'streampetr_vitl_nusc'
SEED = 2 ** 31 + 17


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    from far3d_tpu_torch.models.streampetr_vit import tiny_vit_petr_config
    root = pb_tiny.tiny_root(tmp_path_factory.mktemp('checkout'))
    real = json.loads((pb_tiny.BENCH / 'configs' / f'{CONFIG}.json')
                      .read_text())
    real['model'] = dataclasses.asdict(tiny_vit_petr_config())
    (root / 'portbench' / 'configs' / f'{CONFIG}.json').write_text(
        json.dumps(real))
    return root


def judged(root, control=None):
    from drivers import stream
    cell = pb_tiny.tiny_cell(root, CELL)
    out = stream.run(cell, SEED, 1.0, False, time.perf_counter(),
                     device='cpu', control=control)
    return compare.judge(out['numbers'], pb_tiny.limits(CELL)['limits'])


def test_the_cell_runs_end_to_end_and_is_correct(root):
    ok, rows = judged(root)
    assert ok, rows


def test_the_control_is_not_correct(root):
    ok, rows = judged(root, control=pb_tiny.limits(CELL)['control'])
    assert not ok, rows


def test_the_configuration_is_eva02_l_at_800x1600_uncut():
    config = spec.load_json(pb_tiny.BENCH / 'configs' / f'{CONFIG}.json')
    assert config['reduced'] == []
    for key in ('block_layout', 'rope_scaling', 'pos_table', 'neck',
                'normalization', 'weights'):
        assert config['assumed'][key]
    port = family.load(config, 'port')
    vit_cfg = port.cfg.backbone
    assert (vit_cfg.embed_dim, vit_cfg.depth, vit_cfg.num_heads,
            vit_cfg.embed_dim // vit_cfg.num_heads, vit_cfg.mlp_hidden_dim,
            vit_cfg.patch_size, vit_cfg.window_size,
            len(vit_cfg.global_blocks)) == (1024, 24, 16, 64, 2730, 16, 16,
                                            8)
    assert (port.num_cams, port.input_hw) == (6, (800, 1600))
    assert (port.cfg.num_query, port.cfg.num_propagated, port.cfg.memory_len,
            port.cfg.topk_proposals) == (644, 256, 1024, 256)


def test_attention_work_of_a_global_and_a_windowed_block():
    # one 64x96 camera at patch 16: a 4x6 grid; 4 heads of 16; windows of
    # 4x4 over the grid padded to 4x8
    cfg = dict(patch_size=16, embed_dim=64, num_heads=4, window_size=4,
               depth=2, global_blocks=[1])
    window, glob = vit.attention_calls(cfg, 1, (64, 96))
    assert window['kind'] == 'window' and glob['kind'] == 'global'
    # 24 real queries, 16 keys each (their window's, padded ones too), and
    # 24 keys each in the global block; two matmuls of 2 FLOP a product
    assert window['flops'] == 2 * 2 * 4 * 24 * 16 * 16
    assert glob['flops'] == 2 * 2 * 4 * 24 * 24 * 16
    # q, k, v and o of the 24 real tokens, 64 channels of 2 bytes
    assert window['bytes'] == glob['bytes'] == 4 * 24 * 64 * 2
    least = vit.least_seconds([window, glob])
    assert least == pytest.approx(
        2 * work.bound_seconds(4 * 24 * 64 * 2, 0, 1.0))


def test_full_size_attention_is_6_tera_flop_a_frame():
    config = spec.load_json(pb_tiny.BENCH / 'configs' / f'{CONFIG}.json')
    calls = vit.attention_calls(config['model']['backbone'], 6, (800, 1600))
    assert [c['block'] for c in calls if c['kind'] == 'global'] == \
        [2, 5, 8, 11, 14, 17, 20, 23]
    # 8 x 6 x 4 x 16 x 5,000^2 x 64 + 16 x 4 x 16 x 30,000 x 256 x 64
    assert sum(c['flops'] for c in calls) == 8 * 6 * 4 * 16 * 5000 ** 2 * 64 \
        + 16 * 4 * 16 * 30000 * 256 * 64
    assert 5e-3 < vit.least_seconds(calls) < 7e-3


def test_attention_kernels_count_inside_the_backbone_label_only():
    from harness.trace import Trace
    t = Trace([], (0, 1000))
    t.ops = [(100, 200, 'flash_fwd_kernel<a>', 'kernel', 1),
             (300, 350, 'flash_fwd_kernel<a>', 'kernel', 2),
             (400, 420, 'gemm', 'kernel', 3)]
    t.launch_at = {1: 50, 2: 260, 3: 60}
    t.labels = {'model.backbone': [(0, 100)], 'model.queries': [(250, 300)]}
    t._starts = {k: [s for s, _ in v] for k, v in t.labels.items()}
    assert vit.kernels_under(t, ['flash_fwd_kernel'], 'model.backbone') == \
        (100e-9, 1)
    assert vit.kernels_under(t, ['flash_fwd_kernel'], 'model.neck') is None
