#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (far3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: the MSDA forward and backward kernels from
     far3d_tpu_torch/csrc/msda_fwd.cu and msda_bwd.cu, one nvcc each, both
     started together;
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
     multiply-adds these inputs need;
  7. the tiny train step, f32 and dropout 0, on the card against the CPU:
     two steps from the same grid-mask and DN draws (one CPU generator),
     losses, Adam's first moments (the gradients), updated parameters;
  8. the tiny model overfits one synthetic batch on the card (lr 2e-3,
     warm-up 1, no grid mask, 30 steps): the last 5 losses average below
     0.8 x the first;
  9. the second main path: full-width Far3DConfig() training through
     train_entry, 6 AdamW steps with DN, grid mask, dropout and GT depth,
     bf16 images; finite losses and grad norm, parameters changed, each of
     msda_fwd, msda_dval and msda_dattn launched 6 times a step; ms/step
     and peak memory;
 10. all three kernels against their plain versions on the operands
     (value, loc, weights, grad_out) of decoder layer 0 of a phase-9 step,
     and whether two runs of each backward kernel are bitwise equal;
 11. device times of both backward kernels (warm L2 and after an L2 flush),
     the plain backward, the backward of the grid_sample composite, and
     each kernel's bound from the bytes and operations these operands need.
Then it prints one JSON line of kernels and, last, the device line.
It exits non-zero without printing a result when no card is present.

TF32 is switched off for matmuls and cuDNN convolutions, so that every f32
comparison here is a full-f32 one; the main path's image side is bf16.
"""

import dataclasses
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
from far3d_tpu_torch.entry import build_model, entry, run_frame, train_entry
from far3d_tpu_torch.models.farhead import init_state
from far3d_tpu_torch.ops import _build, msda_cuda
from far3d_tpu_torch.ops.msda import (_corner_data, msda,
                                      msda_backward_reference, msda_reference)
from far3d_tpu_torch.train.step import (create_train_state, draw_step_noise,
                                        step_from_noise, train_step)
from far3d_tpu_torch.utils.synthetic import inference_inputs, synthetic_batch

FRAMES = 8                     # streaming frames on the main path
LAYERS_PER_FRAME = 6           # one MSDA launch per decoder layer
TRAIN_STEPS = 6                # full-width training steps
OVERFIT_STEPS = 30
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
SLEEP_CYCLES_PER_S = 1.98e9    # H100 SXM top SM clock, for torch.cuda._sleep
EDGE_TOL = dict(rtol=1e-5, atol=1e-5)
# Production shape: both sides accumulate in f32 from the same bf16 rows and
# f32 weights and round once to bf16; the sums' orders differ, so one output
# may round one bf16 step (2^-8 relative) apart.
PROD_TOL = dict(rtol=1e-2, atol=1e-3)
TINY_TOL = dict(rtol=1e-3, atol=2e-3)
# Backward at the production training shape, same bf16 inputs on both sides:
# d_value is summed in f32 (atomics on the card, in another order) and
# rounded once to bf16, so one bf16 step (2^-8 relative) apart; d_loc and
# d_weights are f32 sums of up to 4 corners x 256 channels (x 4 levels for
# d_loc) whose terms cancel, so their error is relative to the largest
# entry of the tensor, not to each entry.
BWD_TOL = {'d_value': (1e-2, 1e-3), 'd_loc': (1e-3, 1e-4),
           'd_weights': (1e-3, 1e-4)}   # (rtol, atol as a share of max |x|)


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


def hold_card(one_rep, reps):
    """Queue a device-side sleep long enough for the host to queue `reps`
    calls of `one_rep` behind it: twice the time of one synchronized call
    (host and device) per rep, at most 0.5 s. The card then runs the calls
    back to back, so the events between them time the device alone even
    where a wrapper's host work per call (checks, allocation, the ctypes
    call) takes longer than its kernel, which back-to-back calls without the
    sleep would measure instead."""
    t0 = time.perf_counter()
    one_rep()
    torch.cuda.synchronize()
    hold_s = min(2 * reps * (time.perf_counter() - t0), 0.5)
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))


def device_ms(fn, reps):
    """Mean device time of one call: one CUDA-event pair around `reps`
    back-to-back calls queued behind `hold_card`'s sleep. The operands stay
    in L2 between calls where they fit (the 45.7 MB production value pyramid
    fits the 50 MB L2)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_card(fn, reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_l2_ms(fn, reps):
    """Median device time of one call after L2 is flushed by writing a
    256 MiB buffer, all flushes and calls queued behind `hold_card`'s sleep,
    so each event pair spans the call's device time alone."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device='cuda')

    def flushed():
        flush.zero_()
        fn()

    hold_card(flushed, reps + 1)
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


def no_dropout_f32(cfg):
    """`cfg` with the training dtype f32 and every dropout rate 0."""
    return cfg.replace(
        train=dataclasses.replace(cfg.train, dtype='float32'),
        deform=dataclasses.replace(cfg.deform, dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0,
                                    attn_dropout=0.0))


def tiny_train_card_vs_cpu(dev):
    """Two tiny f32 train steps without dropout on the card (kernels, forward
    and backward) and on the CPU (plain version), from the same grid-mask
    and DN draws. Compared: every loss and the grad norm; Adam's first
    moment of every parameter, which is linear in both steps' clipped
    gradients and so holds each parameter's gradient (rtol 1e-3, atol 2e-3
    of the tensor's largest moment, since summation-order noise scales with
    the tensor's gradient); the parameters and BN statistics after the
    steps. A step moves a parameter by at most about lr, far inside the
    parameters' tolerance, so the moments are what catch a wrong gradient,
    and every parameter with a nonzero moment must have moved on the card."""
    cfg = no_dropout_f32(tiny_test_config())
    gen = torch.Generator().manual_seed(0)
    noises = [draw_step_noise(cfg, 1, gen) for _ in range(2)]
    results = {}
    for device in (dev, torch.device('cpu')):
        state, tstate = create_train_state(cfg, build_model(cfg, device, 0))
        before = {k: p.detach().clone()
                  for k, p in state.model.named_parameters()}
        batch = {k: v.to(device) for k, v in synthetic_batch(cfg, 1, 6).items()}
        metrics = []
        for i, noise in enumerate(noises):
            if i:
                batch['prev_exists'] = torch.ones(1, device=device)
            state, tstate, m = step_from_noise(cfg, state, tstate, batch, noise)
            metrics.append({k: float(v) for k, v in m.items()})
        moments = {k: state.optimizer.state.get(p, {}).get(
            'exp_avg', torch.zeros_like(p)).cpu()
            for k, p in state.model.named_parameters()}
        results[device.type] = (metrics, state.model.state_dict(), moments,
                                before)
    (mg, sg, ag, before), (mc, sc, ac, _) = results['cuda'], results['cpu']
    for i, (a, b) in enumerate(zip(mg, mc)):
        for k in b:
            torch.testing.assert_close(torch.tensor(a[k]), torch.tensor(b[k]),
                                       msg=f'step {i} {k}', **TINY_TOL)
    moved = 0
    for k, want in ac.items():
        scale = want.abs().max().item()
        torch.testing.assert_close(ag[k], want, rtol=1e-3,
                                   atol=max(2e-3 * scale, 1e-12),
                                   msg=f'exp_avg {k}')
        if scale > 0:
            moved += 1
            if torch.equal(before[k], sg[k]):
                raise AssertionError(f'{k} has a gradient but did not move')
    if moved < 0.8 * len(ac):
        raise AssertionError(f'only {moved} of {len(ac)} parameters have a '
                             'gradient')
    for k in sc:
        torch.testing.assert_close(sg[k].cpu(), sc[k], msg=k, **TINY_TOL)
    log(f'  tiny train step card vs CPU: {len(mc[0])} metrics x 2 steps '
        f'(tol {TINY_TOL}), Adam first moments of {len(ac)} parameters '
        f'({moved} with a gradient, each moved on the card; rtol 1e-3, atol '
        f'2e-3 x max |m|), {len(sc)} parameters and buffers (tol {TINY_TOL}) '
        f'agree; total_loss {mg[0]["total_loss"]:.4f} -> '
        f'{mg[1]["total_loss"]:.4f}, grad_norm {mg[0]["grad_norm"]:.3f}')


def tiny_overfit(dev):
    """tests/test_learning.py on the card: one synthetic batch, lr 2e-3,
    warm-up 1, no grid mask."""
    cfg = tiny_test_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, lr=2e-3, warmup_iters=1, use_grid_mask=False))
    state, tstate = create_train_state(cfg, build_model(cfg, dev, 0))
    batch = {k: v.to(dev) for k, v in synthetic_batch(cfg, 1, 3).items()}
    gen = torch.Generator().manual_seed(7)
    dropout_gen = torch.Generator(device=dev).manual_seed(7)
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, _, m = train_step(cfg, state, tstate, batch, gen, dropout_gen)
        losses.append(float(m['total_loss']))
    if not np.isfinite(losses).all():
        raise AssertionError(f'overfit losses not finite: {losses}')
    last = float(np.mean(losses[-5:]))
    if not last < 0.8 * losses[0]:
        raise AssertionError(f'overfit: first {losses[0]:.4f}, mean of the '
                             f'last 5 {last:.4f} (need < 0.8x)')
    log(f'  tiny overfit on the card: total_loss {losses[0]:.4f} -> '
        f'{last:.4f} (mean of the last 5 of {OVERFIT_STEPS}, '
        f'{last / losses[0]:.3f}x)')


def backward_needs(value, shapes, loc, weights):
    """What the two backward kernels must move for these operands, from the
    corners with a nonzero bilinear weight: d_value is written whole, the
    gradient rows of the (camera, query) pairs with a hit and the weights
    of the (camera, query, level, point) with a hit are read by both, all
    of loc too; msda_dattn also reads the value rows a hit corner touches
    and writes d_weights and d_loc whole. Returns (dval bytes, dval FLOP,
    dattn bytes, dattn FLOP, counts)."""
    b, rows, c = value.shape
    _, q, p, _ = loc.shape
    g = weights.shape[2]
    esz = value.element_size()
    cam = torch.arange(b, device=value.device).view(b, 1, 1, 1) * rows
    touched, hit_points, hits, start = [], 0, 0, 0
    query_hit = torch.zeros(b, q, dtype=torch.bool, device=value.device)
    for h, w in shapes:
        idx, bw = _corner_data(loc, h, w)                  # (B, Q, P, 4)
        nz = bw != 0
        touched.append((cam + start + idx)[nz])
        hit_points += int(nz.any(-1).sum())
        hits += int(nz.sum())
        query_hit |= nz.flatten(2).any(-1)
        start += h * w
    rows_read = int(torch.unique(torch.cat(touched)).numel())
    hit_queries = int(query_hit.sum())
    shared = hit_queries * c * esz + hit_points * g * 4 + loc.numel() * 4
    dval_bytes = value.numel() * esz + shared
    dattn_bytes = (rows_read * c * esz + shared + weights.numel() * 4
                   + loc.numel() * 4)
    flops = 2 * hits * c               # one multiply-add per channel and hit
    return dval_bytes, flops, dattn_bytes, flops, dict(
        rows_read=rows_read, hit_points=hit_points, hits=hits,
        hit_queries=hit_queries)


def composite_backward(value, shapes, loc, weights, grad_out):
    """Yardstick: autograd's backward of the grid_sample composite (value,
    loc and weights gradients in f32), the forward taken once outside."""
    with torch.enable_grad():
        v = value.float().requires_grad_()
        l = loc.clone().requires_grad_()
        w = weights.clone().requires_grad_()
        out = grid_sample_msda(v, shapes, l, w)
    g = grad_out.float()
    return lambda: torch.autograd.grad(out, (v, l, w), g, retain_graph=True)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def train_main_path(cfg, card):
    """Phase 9: `TRAIN_STEPS` full-width steps through train_entry with the
    launch counts set to 0 just before and read after each step. Captures
    decoder layer 0's MSDA operands and the gradient autograd hands its
    backward on the first step."""
    t0 = time.perf_counter()
    tstep, (tstate, temporal) = train_entry(cfg)
    torch.cuda.synchronize()
    log(f'  model, optimizer and synthetic batch built in '
        f'{time.perf_counter() - t0:.1f} s')
    model = tstate.model
    sampler = model.pts_bbox_head.transformer['decoder'].layers[0] \
        .attentions[1].sampler
    cap = {}

    def capture_bwd(module, args, out):
        if 'args' in cap or not out.requires_grad:
            return
        cap['args'] = [a.detach().clone() for a in args]

        def grad_hook(g):
            cap['grad_layout'] = (tuple(g.shape), g.stride())
            cap['grad'] = g.detach().contiguous().clone()
        out.register_hook(grad_hook)

    hook = sampler.register_forward_hook(capture_bwd)
    params = dict(model.named_parameters())
    watched = [k for k in params if k.endswith((
        'stem.stem_1/conv.weight', 'multi_level_cls_convs.0.0.conv.weight',
        'layers.0.attentions.1.weights_fc.weight'))]
    before_params = {k: params[k].detach().clone() for k in watched}
    names = (msda_cuda.FWD, msda_cuda.DVAL, msda_cuda.DATTN)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_ms = []
    for i in range(TRAIN_STEPS):
        before = {k: _build.launch_counts[k] for k in names}
        t0 = time.perf_counter()
        tstate, temporal, m = tstep(tstate, temporal)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f'step {i}: non-finite {bad}')
        per = {k: _build.launch_counts[k] - before[k] for k in names}
        if any(v != LAYERS_PER_FRAME for v in per.values()):
            raise AssertionError(f'step {i}: launches {per}, expected '
                                 f'{LAYERS_PER_FRAME} of each')
        log(f'  step {i}: {step_ms[-1]:.1f} ms, total_loss '
            f'{vals["total_loss"]:.4f}, grad_norm {vals["grad_norm"]:.3f}, '
            f'loss_cls {vals["loss_cls"]:.4f}, dn_loss_cls '
            f'{vals["dn_loss_cls"]:.4f}, enc_loss_obj '
            f'{vals["enc_loss_obj"]:.4f}, launches {per}')
    launches = {k: _build.launch_counts[k] for k in names}
    hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(watched) != 3:
        raise AssertionError(f'watched parameters not found: {watched}')
    for k in watched:
        if torch.equal(before_params[k], params[k].detach()):
            raise AssertionError(f'{k} did not change in {TRAIN_STEPS} steps')
    ms_step = statistics.median(step_ms[2:])   # steps 0-1 carry warm-up
    log(f'  launches in {TRAIN_STEPS} steps: {launches} '
        f'({LAYERS_PER_FRAME} of each per step); watched parameters changed')
    log(f'  median of steps 2..{TRAIN_STEPS - 1}: {ms_step:.2f} ms/step, '
        f'first step {step_ms[0]:.1f} ms, peak memory {peak:.2f} GiB '
        f'[{card}]')
    return dict(operands=(*cap['args'], cap['grad']),
                grad_layout=cap['grad_layout'], launches=launches,
                ms_step=ms_step, peak_gib=peak)


def backward_check(value, shapes, loc, weights, grad_out):
    """Phase 10: each backward kernel against the plain backward (BWD_TOL),
    and whether two runs of each are bitwise equal."""
    d_value = msda_cuda.msda_dval(value, shapes, loc, weights, grad_out)
    d_loc, d_weights = msda_cuda.msda_dattn(value, shapes, loc, weights,
                                            grad_out)
    torch.cuda.synchronize()
    ref = msda_backward_reference(value, shapes, loc, weights, grad_out)
    errs, failures = {}, []
    for name, got_t, want_t in zip(('d_value', 'd_loc', 'd_weights'),
                                   (d_value, d_loc, d_weights), ref):
        got_f, want_f = got_t.float(), want_t.float()
        scale = want_f.abs().max().item()
        rtol, atol_share = BWD_TOL[name]
        errs[name] = (got_f - want_f).abs().max().item()
        ok = torch.allclose(got_f, want_f, rtol=rtol, atol=atol_share * scale)
        log(f'  {name} {tuple(got_t.shape)} {got_t.dtype}: max_abs_err '
            f'{errs[name]:.3e}, max |x| {scale:.3e} (rtol {rtol}, atol '
            f'{atol_share} x max |x|): {"ok" if ok else "FAIL"}')
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f'backward kernels disagree: {failures}')
    d_value2 = msda_cuda.msda_dval(value, shapes, loc, weights, grad_out)
    d_loc2, d_weights2 = msda_cuda.msda_dattn(value, shapes, loc, weights,
                                              grad_out)
    dval_bitwise = bool(torch.equal(d_value, d_value2))
    rerun = (d_value.float() - d_value2.float()).abs().max().item()
    dattn_bitwise = bool(torch.equal(d_loc, d_loc2)
                         and torch.equal(d_weights, d_weights2))
    log(f'  two msda_dval runs bitwise equal: {dval_bitwise} (max difference '
        f'{rerun:.3e}: f32 atomics add in a run-dependent order, then round '
        f'to {d_value.dtype}); two msda_dattn runs bitwise equal: '
        f'{dattn_bitwise}')
    return dict(errs=errs, ref=ref, dval_bitwise=dval_bitwise,
                dval_rerun_diff=rerun, dattn_bitwise=dattn_bitwise)


def backward_times(value, shapes, loc, weights, grad_out, ref, card):
    """Phase 11: device times of both kernels (warm L2, and after an L2
    flush), the plain backward and the composite's backward, and each
    kernel's bound from what these operands need."""
    args = (value, shapes, loc, weights, grad_out)
    t = dict(
        dval_ms=device_ms(lambda: msda_cuda.msda_dval(*args), 100),
        dval_cold=cold_l2_ms(lambda: msda_cuda.msda_dval(*args), 30),
        dattn_ms=device_ms(lambda: msda_cuda.msda_dattn(*args), 100),
        dattn_cold=cold_l2_ms(lambda: msda_cuda.msda_dattn(*args), 30),
        plain_ms=device_ms(lambda: msda_backward_reference(*args), 3))
    comp = composite_backward(*args)
    t['library_ms'] = device_ms(comp, 5)
    grads = comp()
    lib_err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(grads[1:], ref[1:]))
    dval_bytes, dval_flops, dattn_bytes, dattn_flops, counts = \
        backward_needs(value, shapes, loc, weights)
    t['dval_bound'], t['dval_by'] = bound(dval_bytes, dval_flops)
    t['dattn_bound'], t['dattn_by'] = bound(dattn_bytes, dattn_flops)
    log(f'  msda_dval {t["dval_ms"]:.4f} ms warm L2 (mean of 100 '
        f'back-to-back), {t["dval_cold"]:.4f} ms after an L2 flush (median of '
        f'30); msda_dattn {t["dattn_ms"]:.4f} / {t["dattn_cold"]:.4f} ms; '
        f'plain backward (all three gradients) {t["plain_ms"]:.4f} ms; '
        f'grid_sample composite backward {t["library_ms"]:.4f} ms (its '
        f'd_loc / d_weights max_abs_err {lib_err:.3e}) [{card}]')
    log(f'  counts: {counts} of {value.shape[0] * value.shape[1]} value rows, '
        f'{loc.shape[0] * loc.shape[1]} (camera, query) pairs, '
        f'{loc.shape[0] * loc.shape[1] * loc.shape[2] * len(shapes)} points')
    log(f'  msda_dval bound {t["dval_bound"]:.4f} ms ({t["dval_by"]}): '
        f'{dval_bytes / 1e6:.2f} MB at 3.35 TB/s, {dval_flops / 1e9:.3f} '
        f'GFLOP f32 at 67 TFLOP/s; msda_dattn bound {t["dattn_bound"]:.4f} ms '
        f'({t["dattn_by"]}): {dattn_bytes / 1e6:.2f} MB, '
        f'{dattn_flops / 1e9:.3f} GFLOP')
    return t


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

    log('== phase 2: build the MSDA forward and backward kernels')
    t0 = time.perf_counter()
    msda_cuda.build()
    log(f'  msda_fwd.cu and msda_bwd.cu built in parallel and loaded in '
        f'{time.perf_counter() - t0:.2f} s')
    for src in ('msda_fwd', 'msda_bwd'):
        log(f'  {src}.cu: nvcc {_build.build_seconds.get(src, 0.0):.2f} s')
        for line in _build.build_logs.get(src, '').splitlines():
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

    del step, state, captured, dets, value, loc, weights, got, want
    torch.cuda.empty_cache()

    log('== phase 7: tiny train step, card vs CPU')
    tiny_train_card_vs_cpu(dev)

    log('== phase 8: tiny overfit on the card')
    tiny_overfit(dev)

    log('== phase 9: full-width Far3DConfig() training (train_entry)')
    train = train_main_path(cfg, card)

    log('== phase 10: all three kernels vs plain at the training shape')
    value, loc, weights, grad_out = train['operands']
    log(f'  value {tuple(value.shape)} {value.dtype}, loc {tuple(loc.shape)}, '
        f'weights {tuple(weights.shape)}, grad_out {tuple(grad_out.shape)} '
        f'{grad_out.dtype} (reached the kernel as shape/strides '
        f'{train["grad_layout"]})')
    torch.cuda.empty_cache()
    with torch.no_grad():
        got = msda_cuda.msda_fwd(value, shapes, loc, weights)
        torch.cuda.synchronize()
        want = msda_reference(value, shapes, loc, weights)
        torch.testing.assert_close(got, want, **PROD_TOL)
        train_fwd_err = (got.float() - want.float()).abs().max().item()
        log(f'  msda_fwd {tuple(got.shape)} {got.dtype}: max_abs_err '
            f'{train_fwd_err:.3e} (tol {PROD_TOL}), output max |x| '
            f'{want.float().abs().max().item():.3e}')
        del got, want
        check = backward_check(value, shapes, loc, weights, grad_out)
        log('== phase 11: backward times at the training shape')
        times = backward_times(value, shapes, loc, weights, grad_out,
                               check['ref'], card)
    ms_step, train_launches = train['ms_step'], train['launches']
    errs = check['errs']

    common = {'route': 'cuda', 'ms_per_frame': ms_frame, 'ms_per_step': ms_step,
              'peak_gib_train': train['peak_gib']}
    bwd_plain = 'msda_backward_reference: autograd through msda_reference, f32'
    bwd_lib = 'backward of F.grid_sample per level + einsum (composite, f32)'
    kernels = {'kernels': [{
        'name': 'msda_fwd', **common,
        'source': 'far3d_tpu_torch/csrc/msda_fwd.cu',
        'replaces': 'far3d_tpu/ops/msda_pallas.py:150',
        'launches': launches, 'train_launches': train_launches['msda_fwd'],
        'max_abs_err': max_abs_err, 'train_max_abs_err': train_fwd_err,
        'ms': kernel_ms, 'kernel_ms': kernel_ms,
        'ms_cold_l2': kernel_cold_ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
        'library_ms': library_ms,
        'library': 'F.grid_sample per level + einsum (composite, f32)',
    }, {
        'name': 'msda_dval', **common,
        'source': 'far3d_tpu_torch/csrc/msda_bwd.cu',
        'replaces': 'far3d_tpu/ops/msda_pallas.py:260',
        'launches': train_launches['msda_dval'],
        'train_launches': train_launches['msda_dval'],
        'max_abs_err': errs['d_value'],
        'bitwise_repeatable': check['dval_bitwise'],
        'ms': times['dval_ms'], 'kernel_ms': times['dval_ms'],
        'ms_cold_l2': times['dval_cold'],
        'plain_ms': times['plain_ms'], 'plain': bwd_plain,
        'bound_ms': times['dval_bound'], 'bound_by': times['dval_by'],
        'library_ms': times['library_ms'], 'library': bwd_lib,
    }, {
        'name': 'msda_dattn', **common,
        'source': 'far3d_tpu_torch/csrc/msda_bwd.cu',
        'replaces': 'far3d_tpu/ops/msda_pallas.py:348',
        'launches': train_launches['msda_dattn'],
        'train_launches': train_launches['msda_dattn'],
        'max_abs_err': max(errs['d_loc'], errs['d_weights']),
        'bitwise_repeatable': check['dattn_bitwise'],
        'ms': times['dattn_ms'], 'kernel_ms': times['dattn_ms'],
        'ms_cold_l2': times['dattn_cold'],
        'plain_ms': times['plain_ms'], 'plain': bwd_plain,
        'bound_ms': times['dattn_bound'], 'bound_by': times['dattn_by'],
        'library_ms': times['library_ms'], 'library': bwd_lib,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
