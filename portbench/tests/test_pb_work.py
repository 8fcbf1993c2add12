"""The yardstick's arithmetic against counts made by hand."""

import dataclasses

import torch

import pb_tiny  # noqa: F401
from harness import spec, work
from harness.trace import Trace


def test_qconv_sites_of_the_tiny_backbone():
    from far3d_tpu_torch.config import tiny_test_config
    bb = dataclasses.asdict(tiny_test_config().backbone)
    sites = work.qconv_sites(bb, 2, (32, 48))
    assert len(sites) == 3 + sum(bb['blocks_per_stage']) * (
        bb['layers_per_block'] + 1)
    s0 = sites[0]                     # stem1: 3 -> c0, k 3, stride 2
    c0 = bb['stem_channels'][0]
    assert s0['ops'] == 2 * 2 * 16 * 24 * c0 * 9 * 3
    assert s0['bytes'] == 2 * 32 * 48 * 3 + c0 * 27 + 8 * c0 + 2 * 16 * 24 * c0
    concat = sites[3 + bb['layers_per_block']]
    cin = bb['stem_channels'][2] + bb['layers_per_block'] * \
        bb['stage_conv_channels'][0]
    co = bb['stage_out_channels'][0]
    assert concat['name'] == 'stage2_block0/concat'
    assert concat['ops'] == 2 * 2 * 8 * 12 * co * cin
    assert concat['bytes'] == 2 * 8 * 12 * cin + co * cin + 8 * co \
        + 2 * 8 * 12 * co * 4


def test_full_width_far3d_backbone_counts_2826_tera_ops():
    cfg = pb_tiny.spec.load_json(pb_tiny.BENCH / 'configs' / 'far3d_av2.json')
    sites = work.qconv_sites(cfg['model']['backbone'], 7, (640, 960))
    assert len(sites) == 99
    assert round(sum(s['ops'] for s in sites) / 1e12, 3) == 2.826


def test_msda_needs_of_one_hand_placed_sample():
    # one camera, one 4x4 level, one query, one point at the centre of
    # pixel (1, 1): a single corner with weight 1 reads one row
    value = torch.randn(1, 16, 8, dtype=torch.bfloat16)
    loc = torch.tensor([[[[1.5 / 4, 1.5 / 4]]]])          # (1, 1, 1, 2)
    weights = torch.ones(1, 1, 2, 1, 1)                    # 2 groups
    nbytes, flops = work.msda_fwd_needs(value, [(4, 4)], loc, weights)
    assert nbytes == 1 * 8 * 2 + 1 * 2 * 4 + 2 * 4 + 1 * 1 * 8 * 2
    assert flops == 2 * 1 * 8
    bwd_bytes, bwd_flops = work.msda_bwd_needs(value, [(4, 4)], loc, weights)
    shared = 1 * 8 * 2 + 1 * 2 * 4 + 2 * 4
    assert bwd_bytes == (16 * 8 * 2 + shared) + (8 * 2 + shared + 2 * 4 + 2 * 4)
    assert bwd_flops == 2 * 2 * 1 * 8


def test_bounds_and_sampling_flops():
    assert work.bound_seconds(3.35e12, 0, 1e12) == 1.0
    assert work.bound_seconds(0, 2e12, 1e12) == 2.0
    assert work.msda_sampling_flops(7, 1156, 4, 13, 256) == \
        2 * 7 * 1156 * 4 * 13 * 256 * 5


def test_kernels_an_op_launches_between_two_of_its_own_belong_to_it():
    t = Trace([], (0, 100))
    t.ops = [(0, 10, 'msda_dval_records_kernel', 'kernel', 1),
             (10, 30, 'cub::DeviceRadixSortOnesweepKernel', 'kernel', 2),
             (30, 35, 'cub::DeviceRadixSortHistogramKernel', 'kernel', 3),
             (35, 40, 'msda_dval_starts_kernel', 'kernel', 4),
             (40, 60, 'elementwise_kernel', 'kernel', 5)]
    assert t.seconds_between('msda_dval_records_kernel',
                             'msda_dval_starts_kernel') == (25e-9, 2)
    assert spec.kernel_brackets('msda_bwd') == [
        ('msda_dval_records_kernel', 'msda_dval_starts_kernel')]
    assert all(' .. ' not in n for n in spec.kernel_names('msda_bwd'))
