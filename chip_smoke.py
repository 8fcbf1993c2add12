#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (far3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: the MSDA forward kernel from far3d_tpu_torch/csrc/msda_fwd.cu;
  3. kernel vs plain version on edge cases (f32), and the tiny model on the
     card against the same model on the CPU;
  4. the main path: full-width Far3DConfig() streaming inference, 7 cameras
     at 640x960 with bf16 images, several frames with the temporal state
     carried, each decoded; the MSDA kernel must launch 6 times a frame;
  5. kernel vs plain version at the production shape (operands captured from
     the first decoder layer of a phase-4 frame, bf16 value pyramid);
  6. CUDA-event device times of the kernel (warm L2 and after an L2 flush),
     the plain version and a grid_sample composite (yardstick only, never
     called by the port), and the kernel's bound from the bytes and
     multiply-adds these inputs need.
Then it prints one JSON line of kernels and, last, the device line.
It exits non-zero without printing a result when no card is present.

TF32 is switched off for matmuls and cuDNN convolutions, so that every f32
comparison here is a full-f32 one; the main path's image side is bf16.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from far3d_tpu_torch.config import Far3DConfig, tiny_test_config
from far3d_tpu_torch.entry import build_model, entry, run_frame
from far3d_tpu_torch.models.farhead import init_state
from far3d_tpu_torch.ops import _build, msda_cuda
from far3d_tpu_torch.ops.msda import _corner_data, msda, msda_reference
from far3d_tpu_torch.utils.synthetic import inference_inputs

FRAMES = 8                     # streaming frames on the main path
LAYERS_PER_FRAME = 6           # one MSDA launch per decoder layer
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
EDGE_TOL = dict(rtol=1e-5, atol=1e-5)
# Production shape: both sides accumulate in f32 from the same bf16 rows and
# f32 weights and round once to bf16; the sums' orders differ, so one output
# may round one bf16 step (2^-8 relative) apart.
PROD_TOL = dict(rtol=1e-2, atol=1e-3)
TINY_TOL = dict(rtol=1e-3, atol=2e-3)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def edge_cases(dev):
    """The MSDA cases of tests/_msda_cases.py: in bounds, mixed, fully
    outside, and u, v exactly at 0, 1 and at pixel centres."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tests'))
    from _msda_cases import CASES
    for name, make in CASES.items():
        value, shapes, loc, weights = make()
        v, loc, w = [torch.from_numpy(a).to(dev) for a in (value, loc, weights)]
        got = msda(v, shapes, loc, w)
        torch.cuda.synchronize()
        want = msda_reference(v, shapes, loc, w)
        torch.testing.assert_close(got, want, **EDGE_TOL)
        if name == 'outside' and torch.count_nonzero(got).item():
            raise AssertionError('fully outside locations gave non-zeros')
        log(f'  edge case {name}: max_abs_err '
            f'{(got - want).abs().max().item():.3e} (tol {EDGE_TOL})')


def tiny_model_card_vs_cpu(dev):
    """The tiny model, f32, on the card (kernel) and on the CPU (plain
    version): the decoded detections and the carried memory must agree."""
    cfg = tiny_test_config()
    results = {}
    for device in (dev, torch.device('cpu')):
        model = build_model(cfg, device, seed=0)
        inputs = {k: torch.from_numpy(v).to(device)
                  for k, v in inference_inputs(cfg, seed=0).items()}
        state = init_state(1, cfg.head, device)
        dets, state = run_frame(model, state, **inputs)
        inputs['prev_exists'] = torch.ones(1, device=device)
        dets, state = run_frame(model, state, **inputs)
        results[device.type] = (dets, state)
    (dg, sg), (dc, sc) = results['cuda'], results['cpu']
    for k in ('scores', 'boxes'):
        torch.testing.assert_close(dg[k].cpu(), dc[k], **TINY_TOL)
    torch.testing.assert_close(sg.embedding.cpu(), sc.embedding, **TINY_TOL)
    log(f'  tiny model card vs CPU: dets and memory agree (tol {TINY_TOL})')


def grid_sample_msda(value, shapes, loc, weights):
    """Yardstick: MSDA as F.grid_sample per level plus an einsum (the
    composite of tests/test_msda_torch_oracle.py), in f32."""
    b, _, c = value.shape
    _, q, p, _ = loc.shape
    g = weights.shape[2]
    grid = 2.0 * loc - 1.0
    out = torch.zeros(b, q, g, c // g, device=value.device)
    off = 0
    for lvl, (h, w) in enumerate(shapes):
        fmap = value[:, off:off + h * w].float().transpose(1, 2).reshape(
            b, c, h, w)
        samp = F.grid_sample(fmap, grid, mode='bilinear', padding_mode='zeros',
                             align_corners=False).reshape(b, g, c // g, q, p)
        out = out + torch.einsum('bgcqp,bqgp->bqgc', samp, weights[:, :, :, lvl])
        off += h * w
    return out.reshape(b, q, c).to(value.dtype)


def device_ms(fn, reps):
    """Mean device time of one call: one CUDA-event pair around `reps`
    back-to-back calls, so the host issues ahead of the card and its launch
    overhead is not counted. The operands stay in L2 between calls where they
    fit (the 45.7 MB production value pyramid fits the 50 MB L2)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_l2_ms(fn, reps):
    """Median device time of one call after L2 is flushed by writing a
    256 MiB buffer. No host sync inside the loop, so the host runs ahead and
    each event pair spans the call's device time alone."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device='cuda')
    pairs = []
    for _ in range(reps + 1):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs[1:])


def needed_bytes(value, shapes, loc, weights, out):
    """Bytes MSDA must move for these inputs: the value rows that some corner
    with a nonzero weight reads, the attention weights of each (camera, query,
    level, point) with a hit, all of loc, and the output. Also returns the
    number of nonzero corner slots."""
    b, rows, c = value.shape
    g = weights.shape[2]
    cam = torch.arange(b, device=value.device).view(b, 1, 1, 1) * rows
    touched, hit_points, hits, start = [], 0, 0, 0
    for h, w in shapes:
        idx, bw = _corner_data(loc, h, w)                  # (B, Q, P, 4)
        nz = bw != 0
        touched.append((cam + start + idx)[nz])
        hit_points += int(nz.any(-1).sum())
        hits += int(nz.sum())
        start += h * w
    rows_read = int(torch.unique(torch.cat(touched)).numel())
    nbytes = (rows_read * c * value.element_size() + hit_points * g * 4
              + loc.numel() * 4 + out.numel() * out.element_size())
    return nbytes, rows_read, hit_points, hits


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log('== phase 1: card')
    log(card)
    log(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'device {kind}, count {torch.cuda.device_count()}, '
        f'TF32 off (matmul and cuDNN)')

    log('== phase 2: build')
    t0 = time.perf_counter()
    msda_cuda._library()
    log(f'  msda_fwd loaded in {time.perf_counter() - t0:.2f} s '
        f'(nvcc {_build.build_seconds.get("msda_fwd", 0.0):.2f} s)')
    for line in _build.build_logs.get('msda_fwd', '').splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'  ptxas: {line.strip()}')

    log('== phase 3: kernel vs plain, edge cases; tiny model card vs CPU')
    edge_cases(dev)
    tiny_model_card_vs_cpu(dev)

    log('== phase 4: full-width Far3DConfig() streaming inference')
    cfg = Far3DConfig()
    t0 = time.perf_counter()
    step, (state,) = entry(cfg)
    torch.cuda.synchronize()
    log(f'  model built with seeded weights in {time.perf_counter() - t0:.1f} s')
    sampler = step.model.pts_bbox_head.transformer['decoder'].layers[0] \
        .attentions[1].sampler
    captured = {}

    def capture(module, args):
        if not captured:
            captured['args'] = [a.detach().clone() for a in args]

    hook = sampler.register_forward_pre_hook(capture)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    frame_ms = []
    for i in range(FRAMES):
        t0 = time.perf_counter()
        dets, state = step(state, prev_exists=torch.full((1,), float(i > 0),
                                                         device=dev),
                           timestamp=torch.full((1,), 0.1 * i, device=dev))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        for k in ('scores', 'boxes'):
            if not torch.isfinite(dets[k]).all():
                raise AssertionError(f'frame {i}: non-finite {k}')
        if dets['boxes'].shape != (1, cfg.head.max_decode_num, 9):
            raise AssertionError(f'frame {i}: boxes {tuple(dets["boxes"].shape)}')
        log(f'  frame {i}: {frame_ms[-1]:.1f} ms, top score '
            f'{dets["scores"][0, 0].item():.4f}, valid '
            f'{int(dets["valid"].sum())}')
    launches = _build.launch_counts['msda_fwd']
    hook.remove()
    if launches != LAYERS_PER_FRAME * FRAMES:
        raise AssertionError(f'msda_fwd launched {launches} times in {FRAMES} '
                             f'frames, expected {LAYERS_PER_FRAME * FRAMES}')
    steady = frame_ms[2:]          # frames 0-1 carry cuDNN and allocator warm-up
    ms_frame = statistics.median(steady)
    log(f'  msda_fwd launches: {launches} ({LAYERS_PER_FRAME} per frame)')
    log(f'  median of frames 2..{FRAMES - 1}: {ms_frame:.2f} ms/frame, '
        f'{1e3 / ms_frame:.2f} frames/s, first frame {frame_ms[0]:.1f} ms, '
        f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB '
        f'[{card}]')

    log('== phase 5: kernel vs plain at the production shape')
    value, loc, weights = captured['args']
    shapes = sampler.spatial_shapes
    log(f'  value {tuple(value.shape)} {value.dtype}, loc {tuple(loc.shape)}, '
        f'weights {tuple(weights.shape)}')
    with torch.inference_mode():
        got = msda_cuda.msda_fwd(value, shapes, loc, weights)
        torch.cuda.synchronize()
        want = msda_reference(value, shapes, loc, weights)
        torch.testing.assert_close(got, want, **PROD_TOL)
        max_abs_err = (got.float() - want.float()).abs().max().item()
        log(f'  max_abs_err {max_abs_err:.3e} (tol {PROD_TOL}), output max '
            f'|x| {want.float().abs().max().item():.3e}')

        log('== phase 6: times at the production shape')
        kernel_ms = device_ms(lambda: msda_cuda.msda_fwd(value, shapes, loc,
                                                         weights), 200)
        kernel_cold_ms = cold_l2_ms(lambda: msda_cuda.msda_fwd(
            value, shapes, loc, weights), 50)
        plain_ms = device_ms(lambda: msda_reference(value, shapes, loc,
                                                    weights), 10)
        library_ms = device_ms(lambda: grid_sample_msda(value, shapes, loc,
                                                        weights), 20)
        lib_err = (grid_sample_msda(value, shapes, loc, weights).float()
                   - want.float()).abs().max().item()
        # least time: the bytes these locations need (rows hit, weights of
        # points hit, loc, output) against the multiply-adds of the hits
        all_bytes = (value.numel() * value.element_size() + loc.numel() * 4
                     + weights.numel() * 4 + got.numel() * got.element_size())
        nbytes, rows_read, hit_points, hits = needed_bytes(
            value, shapes, loc, weights, got)
        flops = 2 * hits * value.shape[-1]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
    log(f'  kernel {kernel_ms:.4f} ms warm L2 (mean of 200 back-to-back), '
        f'{kernel_cold_ms:.4f} ms after an L2 flush (median of 50); plain '
        f'{plain_ms:.4f} ms, grid_sample composite {library_ms:.4f} ms '
        f'(its max_abs_err {lib_err:.3e}) [{card}]')
    log(f'  bound {bound_ms:.4f} ms: {nbytes / 1e6:.2f} MB needed '
        f'({rows_read} of {value.shape[0] * value.shape[1]} value rows, '
        f'weights of {hit_points} of {loc.shape[0] * loc.shape[1] * loc.shape[2] * len(shapes)} '
        f'points) at 3.35 TB/s = {t_bytes:.4f} ms (all inputs once: '
        f'{all_bytes / 1e6:.2f} MB = {all_bytes / HBM_BYTES_PER_S * 1e3:.4f} '
        f'ms); {hits} corner hits, {flops / 1e9:.3f} GFLOP f32 at 67 TFLOP/s '
        f'= {t_ops:.4f} ms')

    kernels = {'kernels': [{
        'name': 'msda_fwd', 'route': 'cuda',
        'source': 'far3d_tpu_torch/csrc/msda_fwd.cu',
        'replaces': 'far3d_tpu/ops/msda_pallas.py:150',
        'launches': launches, 'max_abs_err': max_abs_err,
        'ms': kernel_ms, 'kernel_ms': kernel_ms,
        'ms_cold_l2': kernel_cold_ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
        'library_ms': library_ms,
        'library': 'F.grid_sample per level + einsum (composite, f32)',
        'ms_per_frame': ms_frame,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
