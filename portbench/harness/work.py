"""The yardstick's arithmetic: the chip's published peaks, and the work an
op or a model must do, counted from shapes and operands, never from what a
kernel reports.

- ``msda_fwd_needs`` / ``msda_bwd_needs``: the bytes (and FLOP) the MSDA
  forward and its two backward kernels must move for these operands
  (copies of ``chip_smoke.py:needed_bytes`` and ``backward_needs``).
- ``qconv_sites``: the int8 backbone's 99 conv sites from the
  configuration's shapes, each with its operations and bytes (the site
  arithmetic of ``chip_smoke.py:qconv_site_times``).
- ``least_seconds``: the least time of a piece of work at the peaks.
- ``msda_sampling_flops``: the MSDA sampling's multiply-adds, which a FLOP
  counter of the matmuls does not see."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from reference.ops.msda import _corner_data

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity.
PEAKS = {
    'bf16_flops': 989e12,
    'int8_ops': 1979e12,
    'f32_flops': 67e12,      # outside the tensor cores
    'hbm_bytes': 3.35e12,
}


def bound_seconds(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The larger of the bytes at the HBM bandwidth and the operations at
    `ops_per_s`."""
    return max(nbytes / PEAKS['hbm_bytes'], ops / ops_per_s)


def _hits(value, shapes, loc):
    b, rows, _ = value.shape
    cam = torch.arange(b, device=value.device).view(b, 1, 1, 1) * rows
    touched, hit_points, hits, start = [], 0, 0, 0
    query_hit = torch.zeros(b, loc.shape[1], dtype=torch.bool,
                            device=value.device)
    for h, w in shapes:
        idx, bw = _corner_data(loc.float(), h, w)           # (B, Q, P, 4)
        nz = bw != 0
        touched.append((cam + start + idx)[nz])
        hit_points += int(nz.any(-1).sum())
        hits += int(nz.sum())
        query_hit |= nz.flatten(2).any(-1)
        start += h * w
    rows_read = int(torch.unique(torch.cat(touched)).numel())
    return rows_read, hit_points, hits, int(query_hit.sum())


@torch.no_grad()
def msda_fwd_needs(value, shapes, loc, weights) -> Tuple[int, int]:
    """(bytes, FLOP) the forward must move and compute: the value rows that
    some corner with a nonzero weight reads, the attention weights of each
    (camera, query, level, point) with a hit, all of loc, and the output
    (B, Q, C) in the value's dtype; one multiply-add per channel and hit."""
    b, _, c = value.shape
    g = weights.shape[2]
    rows_read, hit_points, hits, _ = _hits(value, shapes, loc)
    out_bytes = b * loc.shape[1] * c * value.element_size()
    nbytes = (rows_read * c * value.element_size() + hit_points * g * 4
              + loc.numel() * 4 + out_bytes)
    return nbytes, 2 * hits * c


@torch.no_grad()
def msda_bwd_needs(value, shapes, loc, weights) -> Tuple[int, int]:
    """(bytes, FLOP) of the value gradient and the location / weight
    gradient together: d_value is written whole, the gradient rows of the
    (camera, query) pairs with a hit and the weights of the (camera, query,
    level, point) with a hit are read by both, all of loc too; the second
    also reads the value rows a hit corner touches and writes d_weights and
    d_loc whole."""
    b, rows, c = value.shape
    esz = value.element_size()
    g = weights.shape[2]
    rows_read, hit_points, hits, hit_queries = _hits(value, shapes, loc)
    shared = hit_queries * c * esz + hit_points * g * 4 + loc.numel() * 4
    dval = value.numel() * esz + shared
    dattn = (rows_read * c * esz + shared + weights.numel() * 4
             + loc.numel() * 4)
    return dval + dattn, 2 * (2 * hits * c)


def out_size(size: int, k: int, stride: int) -> int:
    """Output extent of a SAME-padded conv."""
    return (size + 2 * ((k - 1) // 2) - k) // stride + 1


def qconv_sites(backbone: Dict, num_images: int,
                hw: Sequence[int]) -> List[Dict]:
    """The int8 VoVNet's conv sites in order (3 stem convs, then per OSA
    block its layer convs and its concat conv, which writes float32), each
    {name, ops, bytes}: ops = 2 n ho wo co k k ci; bytes = the input, the
    weights, two float32 multipliers a channel and the output."""
    sites = []
    h, w = hw

    def site(name, ci, co, k, stride, float_out=False):
        nonlocal h, w
        ho, wo = out_size(h, k, stride), out_size(w, k, stride)
        ops = 2 * num_images * ho * wo * co * k * k * ci
        nbytes = (num_images * h * w * ci + co * k * k * ci + 8 * co
                  + num_images * ho * wo * co * (4 if float_out else 1))
        sites.append(dict(name=name, ops=ops, bytes=nbytes))
        h, w = ho, wo

    stem = backbone['stem_channels']
    site('stem1', 3, stem[0], 3, 2)
    site('stem2', stem[0], stem[1], 3, 1)
    site('stem3', stem[1], stem[2], 3, 2)
    cin = stem[2]
    for si, blocks in enumerate(backbone['blocks_per_stage']):
        if si > 0:                               # 3x3 stride-2 max pool
            h, w = -(-h // 2), -(-w // 2)
        sc = backbone['stage_conv_channels'][si]
        cc = backbone['stage_out_channels'][si]
        for bi in range(blocks):
            name = f'stage{si + 2}_block{bi}'
            c = cin
            for li in range(backbone['layers_per_block']):
                site(f'{name}/layer{li}', c, sc, 3, 1)
                c = sc
            site(f'{name}/concat', cin + backbone['layers_per_block'] * sc,
                 cc, 1, 1, float_out=True)
            cin = cc
    return sites


def qconv_bound_seconds(sites: List[Dict]) -> float:
    """The larger of operations at the int8 peak and bytes at the HBM
    bandwidth, per site, summed."""
    return sum(bound_seconds(s['bytes'], s['ops'], PEAKS['int8_ops'])
               for s in sites)


def msda_sampling_flops(num_cams: int, queries: int, levels: int,
                        points: int, channels: int) -> int:
    """One multiply-add per channel for each of the 4 corners of every
    (camera, query, level, point) sample, and one per channel for the
    attention weight."""
    return 2 * num_cams * queries * levels * points * channels * 5


def count_flops(fn) -> Tuple[object, int]:
    """(fn's result, the FLOP ``torch.utils.flop_counter`` counts in it:
    matmuls, convolutions and attention)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, int(counter.get_total_flops())
