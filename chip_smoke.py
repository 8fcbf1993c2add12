#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (far3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel source of the port (far3d_tpu_torch/csrc/msda_fwd.cu,
     msda_bwd.cu, osa_fused.cu), one nvcc each, all started together;
  3. kernel vs plain version on the shared cases of tests/_msda_cases.py
     (f32: edge cases, crowded, production_like, rows_past_int16,
     sparse_pairs; msda_fwd, and msda_dval and msda_dattn within BWD_TOL),
     and the tiny model on the card against the same model on the CPU;
  4. the main path: full-width Far3DConfig() streaming inference, 7 cameras
     at 640x960 with bf16 images, several frames with the temporal state
     carried, each decoded; the MSDA kernel must launch 6 times a frame;
  5. kernel vs plain version at the production shape (operands captured from
     the first decoder layer of a phase-4 frame, bf16 value pyramid), and
     whether two runs are bitwise equal;
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
     (value, loc, weights, grad_out) of decoder layer 0 of a phase-9 step;
     two runs of msda_dval, and two runs of msda_dattn, must be bitwise
     equal;
 11. device times of both backward kernels and of msda_fwd on these
     operands (warm L2 and after an L2 flush), msda_dval's device time by
     launch (torch.profiler), the plain backward, the backward of the
     grid_sample composite for all three gradients and for loc and weights
     alone (msda_dattn's function), and each kernel's bound from the bytes
     and operations these operands need;
 12. the fused OSA block against its plain version at small and awkward
     shapes (1 and 3 cameras, w one less and much less than wp, 16 and 160
     conv channels, 512 output channels, rows past one tile, a bias that
     makes ReLU zero a whole stage);
 13. the third main path: the eight identity blocks OSA4_2 .. OSA4_9 of the
     full-width VoVNet-99, with the model's own seeded weights packed for the
     kernel, on the stage-4 input of a phase-4 frame ((7, 768, 40, 60) bf16),
     each block through osa_block (the osa_fused kernel, then the eSE gate
     from tsum and the identity add); 8 launches, finite outputs, zero halo
     rows and pad columns after every block, and the result against the
     model's own stage4[1:] (cuDNN) on the same input; then the device time
     of the eight blocks both ways;
 14. osa_fused against its plain version on the operands of OSA4_2 and of
     OSA3_2 (80x120, wp 128, 512 -> 160 -> 512), and whether two runs are
     bitwise equal;
 15. device times of one stage-4 block: the kernel (warm L2 and after an L2
     flush), the plain version, the same folded function through cuDNN and
     one matmul (yardstick only, never called by the port), the model's own
     unfused conv / BN / ReLU chain, and the bound from the block's
     operations and bytes;
 16. the fourth main path, from a dataset on disk to the AV2 metrics at full
     Far3DConfig() width, in a temporary directory: the full-size learnable
     dataset (2 scenes x 4 frames, 7 native AV2 cameras, PNG) written;
     TrainLoader (8 threads) feeding run_training for 6 steps with GT depth
     for steps 0-2, log_every 1 and checkpoint_every 4: the steps seen, 6
     finite metrics lines, saves at steps 1, 4 and (forced) 6 with only 6
     kept; step 6 restored into a fresh state and held bitwise against the
     live one; a resume to step 8; each MSDA kernel launched 6 times a step;
     4 more steps from batches taken from the loader first, so that its
     threads are idle while they run;
     EvalLoader over the 8 frames feeding run_inference (uint8 frames
     uploaded ahead, msda_fwd 6 times a frame) and collect_and_evaluate
     (finite mAP and CDS); the loader's host ms a frame and its warp's,
     ms/step and the wait on the loader, eval ms/frame and peak memory.
Then it prints one JSON line of kernels and, last, the device line.
It exits non-zero without printing a result when no card is present.

TF32 is switched off for matmuls and cuDNN convolutions, so that every f32
comparison here is a full-f32 one; the main path's image side is bf16.
"""

import dataclasses
import importlib
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from far3d_tpu_torch.config import Far3DConfig, tiny_test_config
from far3d_tpu_torch.data import pipeline
from far3d_tpu_torch.data.av2_dataset import AV2SequenceDataset
from far3d_tpu_torch.data.loader import EvalLoader, TrainLoader
from far3d_tpu_torch.entry import build_model, entry, run_frame, train_entry
from far3d_tpu_torch.eval.runner import collect_and_evaluate, run_inference
from far3d_tpu_torch.models.farhead import init_state
from far3d_tpu_torch.ops import _build, msda_cuda, osa, osa_cuda
from far3d_tpu_torch.ops.msda import (_corner_data, msda,
                                      msda_backward_reference, msda_reference)
from far3d_tpu_torch.train.step import (create_train_state, draw_step_noise,
                                        step_from_noise, train_step)
from far3d_tpu_torch.train import runner
from far3d_tpu_torch.utils.checkpoint import CheckpointManager
from far3d_tpu_torch.utils.convert import init_state_dict
from far3d_tpu_torch.utils.synthetic import (inference_inputs,
                                             make_learnable_dataset_fullsize,
                                             synthetic_batch)

FRAMES = 8                     # streaming frames on the main path
LAYERS_PER_FRAME = 6           # one MSDA launch per decoder layer
TRAIN_STEPS = 6                # full-width training steps
OVERFIT_STEPS = 30
OSA_BLOCKS = 8                 # OSA4_2 .. OSA4_9, the identity blocks of stage 4
DATA_SCENES, DATA_FRAMES = 2, 4    # the dataset of phase 16: 8 frames
DATA_STEPS = 6                 # run_training's first run, then a resume to
DATA_RESUME_STEPS = 8
DATA_GT_DEPTH_UNTIL = 3        # steps 0-2 with GT depth, 3-7 without
DATA_SAVE_EVERY = 4            # a save at step 4, a forced one at step 6
DATA_IDLE_STEPS = 4            # then steps 8-11 with the loader idle
# The eight fused blocks against the model's own modules: the model rounds
# each conv to bf16 and applies the BN as a bf16 multiply and a bf16 add, the
# kernel applies it in f32 on the f32 sum and rounds once, so each of a
# block's six stages may differ by a bf16 step or two, and the identity adds
# carry the differences on through eight blocks: the largest difference is
# held to 5% of the output's largest entry (13 bf16 steps) and the mean
# difference to 0.5%.
OSA_PATH_TOL = dict(max_share=5e-2, mean_share=5e-3)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 on the tensor cores
SLEEP_CYCLES_PER_S = 1.98e9    # H100 SXM top SM clock, for torch.cuda._sleep
EDGE_TOL = dict(rtol=1e-5, atol=1e-5)
# Production shape: both sides accumulate in f32 from the same bf16 rows and
# f32 weights and round once to bf16; the sums' orders differ, so one output
# may round one bf16 step (2^-8 relative) apart.
PROD_TOL = dict(rtol=1e-2, atol=1e-3)
TINY_TOL = dict(rtol=1e-3, atol=2e-3)
# Backward at the production training shape, same bf16 inputs on both sides:
# d_value is summed in f32 (on the card by value row, in the order of the
# sorted hit records, so in another order than autograd's) and rounded once
# to bf16, so one bf16 step (2^-8 relative) apart; d_loc and
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


def shared_cases(name):
    """tests/_msda_cases.py or tests/_osa_cases.py: the cases this script
    shares with the card tests (tests/test_torch_port_cuda.py)."""
    tests = str(Path(__file__).resolve().parent / 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def edge_cases(dev):
    """The MSDA cases of tests/_msda_cases.py: in bounds, mixed, fully
    outside, u, v exactly at 0, 1 and at pixel centres, crowded,
    production_like, rows_past_int16 and sparse_pairs; msda_fwd within
    EDGE_TOL, msda_dval and msda_dattn (grad_out from seed 7, as in the card
    tests, which hold them to tighter tolerances) within BWD_TOL."""
    for name, make in shared_cases('_msda_cases').CASES.items():
        value, shapes, loc, weights = make()
        g = np.random.RandomState(7).randn(value.shape[0], loc.shape[1],
                                           value.shape[2]).astype(np.float32)
        v, loc, w, g = [torch.from_numpy(a).to(dev)
                        for a in (value, loc, weights, g)]
        got = msda(v, shapes, loc, w)
        torch.cuda.synchronize()
        want = msda_reference(v, shapes, loc, w)
        torch.testing.assert_close(got, want, **EDGE_TOL)
        if name == 'outside' and torch.count_nonzero(got).item():
            raise AssertionError('fully outside locations gave non-zeros')
        args = (v, shapes, loc, w, g)
        errs = hold_backward(
            (msda_cuda.msda_dval(*args), *msda_cuda.msda_dattn(*args)),
            msda_backward_reference(*args), f'edge case {name}')
        log(f'  edge case {name}: max_abs_err '
            f'{(got - want).abs().max().item():.3e} (tol {EDGE_TOL}); '
            + ', '.join(f'{k} {e:.3e} (max |x| {m:.3e})'
                        for k, (e, m) in errs.items()))


def hold_backward(got, ref, what):
    """(d_value, d_loc, d_weights) against the plain backward's within
    BWD_TOL: {name: (max_abs_err, max |x|)}; raises naming any outside it."""
    torch.cuda.synchronize()
    errs, failures = {}, []
    for name, got_t, want_t in zip(('d_value', 'd_loc', 'd_weights'), got,
                                   ref):
        got_f, want_f = got_t.float(), want_t.float()
        scale = want_f.abs().max().item()
        rtol, atol_share = BWD_TOL[name]
        errs[name] = ((got_f - want_f).abs().max().item(), scale)
        if not torch.allclose(got_f, want_f, rtol=rtol,
                              atol=atol_share * scale):
            failures.append(name)
    if failures:
        raise AssertionError(f'{what}: backward kernels disagree on '
                             f'{failures} (max_abs_err, max |x|: {errs})')
    return errs


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
    calls of `one_rep` behind it: 1.5 times the host's time to queue `reps`
    calls, measured just before without waiting for the card, plus 10 ms, at
    most 2 s. The card then runs the calls back to back, so the events
    between them time the device alone even where a wrapper's host work per
    call (checks, allocation, the ctypes calls, a torch sort) takes longer
    than its kernels, which back-to-back calls without the sleep would
    measure instead."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_rep()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_s = min(1.5 * host_s + 0.01, 2.0)
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


def launch_breakdown(fn, reps=20):
    """Device time of each kernel that one call of `fn` launches (mean over
    `reps` calls under torch.profiler), largest first: [(name, ms)]."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, 'is_user_annotation', False)):
            ms[ev.name] = ms.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return sorted(((k, v / reps) for k, v in ms.items()), key=lambda kv: -kv[1])


def composite_backward(value, shapes, loc, weights, grad_out, d_value=True):
    """Yardstick: autograd's backward of the grid_sample composite (value,
    loc and weights gradients in f32; without d_value, loc and weights
    alone, msda_dattn's function), the forward taken once outside."""
    with torch.enable_grad():
        v = value.float().requires_grad_(d_value)
        l = loc.clone().requires_grad_()
        w = weights.clone().requires_grad_()
        out = grid_sample_msda(v, shapes, l, w)
    g = grad_out.float()
    wrt = (v, l, w) if d_value else (l, w)
    return lambda: torch.autograd.grad(out, wrt, g, retain_graph=True)


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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
    """Phase 10: each backward kernel against the plain backward (BWD_TOL);
    two msda_dval runs must be bitwise equal, and so must two msda_dattn
    runs (d_loc and d_weights)."""
    d_value = msda_cuda.msda_dval(value, shapes, loc, weights, grad_out)
    d_loc, d_weights = msda_cuda.msda_dattn(value, shapes, loc, weights,
                                            grad_out)
    ref = msda_backward_reference(value, shapes, loc, weights, grad_out)
    errs = {}
    for (name, (err, scale)), got_t in zip(
            hold_backward((d_value, d_loc, d_weights), ref,
                          'training operands').items(),
            (d_value, d_loc, d_weights)):
        rtol, atol_share = BWD_TOL[name]
        errs[name] = err
        log(f'  {name} {tuple(got_t.shape)} {got_t.dtype}: max_abs_err '
            f'{err:.3e}, max |x| {scale:.3e} (rtol {rtol}, atol '
            f'{atol_share} x max |x|): ok')
    d_value2 = msda_cuda.msda_dval(value, shapes, loc, weights, grad_out)
    d_loc2, d_weights2 = msda_cuda.msda_dattn(value, shapes, loc, weights,
                                              grad_out)
    dval_bitwise = bool(torch.equal(d_value, d_value2))
    rerun = (d_value.float() - d_value2.float()).abs().max().item()
    dattn_bitwise = bool(torch.equal(d_loc, d_loc2)
                         and torch.equal(d_weights, d_weights2))
    log(f'  two msda_dval runs bitwise equal: {dval_bitwise} (max difference '
        f'{rerun:.3e}); two msda_dattn runs bitwise equal: {dattn_bitwise}')
    if not dval_bitwise:
        raise AssertionError('two msda_dval runs on the same operands differ')
    if not dattn_bitwise:
        raise AssertionError('two msda_dattn runs on the same operands differ')
    return dict(errs=errs, ref=ref, dval_bitwise=dval_bitwise,
                dval_rerun_diff=rerun, dattn_bitwise=dattn_bitwise)


def backward_times(value, shapes, loc, weights, grad_out, ref, card):
    """Phase 11: device times of both backward kernels and of msda_fwd
    (warm L2, and after an L2 flush), the plain backward and the
    composite's backward, and each kernel's bound from what these operands
    need."""
    args = (value, shapes, loc, weights, grad_out)
    fwd_args = args[:4]
    t = dict(
        fwd_ms=device_ms(lambda: msda_cuda.msda_fwd(*fwd_args), 100),
        fwd_cold=cold_l2_ms(lambda: msda_cuda.msda_fwd(*fwd_args), 30),
        # 20 calls: a call queues 14 launches and copies, and a stream
        # holds about a thousand before the host must wait for the card
        dval_ms=device_ms(lambda: msda_cuda.msda_dval(*args), 20),
        dval_cold=cold_l2_ms(lambda: msda_cuda.msda_dval(*args), 30),
        dattn_ms=device_ms(lambda: msda_cuda.msda_dattn(*args), 100),
        dattn_cold=cold_l2_ms(lambda: msda_cuda.msda_dattn(*args), 30),
        plain_ms=device_ms(lambda: msda_backward_reference(*args), 3))
    comp = composite_backward(*args)
    t['library_ms'] = device_ms(comp, 5)
    grads = comp()
    lib_err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(grads[1:], ref[1:]))
    del grads, comp
    comp = composite_backward(*args, d_value=False)
    t['dattn_library_ms'] = device_ms(comp, 5)
    grads = comp()
    dattn_lib_err = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(grads, ref[1:]))
    del grads, comp
    dval_bytes, dval_flops, dattn_bytes, dattn_flops, counts = \
        backward_needs(value, shapes, loc, weights)
    t['dval_bound'], t['dval_by'] = bound(dval_bytes, dval_flops)
    t['dattn_bound'], t['dattn_by'] = bound(dattn_bytes, dattn_flops)
    fwd_bytes, _, _, fwd_hits = needed_bytes(
        value, shapes, loc, weights, grad_out)       # output: grad_out's size
    t['fwd_bound'], t['fwd_by'] = bound(fwd_bytes, 2 * fwd_hits * value.shape[-1])
    t['dval_parts'] = launch_breakdown(lambda: msda_cuda.msda_dval(*args))
    log('  msda_dval by launch (torch.profiler, mean of 20 calls): ' + '; '.join(
        f'{name[:70]} {ms:.4f} ms' for name, ms in t['dval_parts']))
    log(f'  msda_fwd {t["fwd_ms"]:.4f} ms warm L2 (mean of 100 back-to-back), '
        f'{t["fwd_cold"]:.4f} ms after an L2 flush (median of 30); bound '
        f'{t["fwd_bound"]:.4f} ms ({t["fwd_by"]}): {fwd_bytes / 1e6:.2f} MB '
        f'[{card}]')
    log(f'  msda_dval {t["dval_ms"]:.4f} ms warm L2 (mean of 20 '
        f'back-to-back), {t["dval_cold"]:.4f} ms after an L2 flush (median of '
        f'30); msda_dattn {t["dattn_ms"]:.4f} / {t["dattn_cold"]:.4f} ms; '
        f'plain backward (all three gradients) {t["plain_ms"]:.4f} ms; '
        f'grid_sample composite backward {t["library_ms"]:.4f} ms (its '
        f'd_loc / d_weights max_abs_err {lib_err:.3e}), for loc and weights '
        f'alone {t["dattn_library_ms"]:.4f} ms (max_abs_err '
        f'{dattn_lib_err:.3e}) [{card}]')
    log(f'  counts: {counts} of {value.shape[0] * value.shape[1]} value rows, '
        f'{loc.shape[0] * loc.shape[1]} (camera, query) pairs, '
        f'{loc.shape[0] * loc.shape[1] * loc.shape[2] * len(shapes)} points')
    log(f'  msda_dval bound {t["dval_bound"]:.4f} ms ({t["dval_by"]}): '
        f'{dval_bytes / 1e6:.2f} MB at 3.35 TB/s, {dval_flops / 1e9:.3f} '
        f'GFLOP f32 at 67 TFLOP/s; msda_dattn bound {t["dattn_bound"]:.4f} ms '
        f'({t["dattn_by"]}): {dattn_bytes / 1e6:.2f} MB, '
        f'{dattn_flops / 1e9:.3f} GFLOP')
    return t


def nhwc_plane(x_nchw, wp):
    """A backbone activation (n, c, h, w) in the fused block's padded rows."""
    return osa.pad_plane(x_nchw.permute(0, 2, 3, 1), wp).contiguous()


def zero_borders(x_pad, sh):
    """Whether the halo rows and the pad columns of a padded plane are zero."""
    r = sh['h'] * sh['wp']
    plane = x_pad[:, osa.HALO:osa.HALO + r].reshape(
        x_pad.shape[0], sh['h'], sh['wp'], -1)
    return not (x_pad[:, :osa.HALO].any() or x_pad[:, osa.HALO + r:].any()
                or plane[:, :, sh['w']:].any())


def osa_small_shapes(dev):
    """Phase 12: the kernel against osa_reference at the shapes of
    tests/_osa_cases.py (tolerance there: one bf16 step of the largest entry
    per stage, six stages; tsum 1e-3 of its largest; exact zero borders)."""
    shared = shared_cases('_osa_cases')
    cases = [(name, sh, None) for name, sh in sorted(shared.OSA_SHAPES.items())]
    cases.append(('negative_bias_zeroes_stage_3',
                  shared.OSA_SHAPES['n3_w_much_less_than_wp'], 2))
    for seed, (name, sh, negative) in enumerate(cases):
        operands = shared.osa_operands(sh, seed, dev, negative_stage=negative)
        got = osa.fused_osa(*operands, sh)
        torch.cuda.synchronize()
        err, terr = shared.assert_osa_close(
            got, osa.osa_reference(*operands, sh), sh)
        log(f'  {name} {sh}: y max_abs_err {err:.3e}, tsum max_abs_err '
            f'{terr:.3e} (tol: y 6 x 2^-8 x max |y|, tsum 1e-3 x max)')


def osa_main_path(stage4, x_in, sh, card):
    """Phase 13: OSA4_2 .. OSA4_9 through osa_block, the launch count set to
    0 just before and read just after, against the model's own modules."""
    blocks = list(stage4)[1:]
    if len(blocks) != OSA_BLOCKS:
        raise AssertionError(f'stage 4 has {len(blocks)} identity blocks')
    packed = [osa.pack_osa_weights(m) for m in blocks]
    mask = osa.interior_mask(sh['h'], sh['w'], sh['wp'], device=x_in.device)
    x_pad = nhwc_plane(x_in, sh['wp'])
    if not zero_borders(x_pad, sh):
        raise AssertionError('pad_plane left non-zero borders')

    def fused_chain(x_pad):
        outs = []
        for module, weights in zip(blocks, packed):
            x_pad = osa.osa_block(module, x_pad, mask, weights, sh)
            outs.append(x_pad)
        return outs

    def model_chain(x):
        for module in blocks:
            x = module(x)
        return x

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs = fused_chain(x_pad)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if launches['osa_fused'] != OSA_BLOCKS or any(
            v for k, v in launches.items() if k != 'osa_fused'):
        raise AssertionError(f'launches on the third path: {launches}, '
                             f'expected osa_fused {OSA_BLOCKS} and no other')
    for i, out in enumerate(outs):
        if out.dtype != torch.bfloat16 or not torch.isfinite(out).all():
            raise AssertionError(f'block {i}: output not finite bf16')
        if not zero_borders(out, sh):
            raise AssertionError(f'block {i}: halo rows or pad columns are '
                                 'not zero')
    got = osa.unpad_plane(outs[-1], sh['h'], sh['w'], sh['wp']).float()
    want = model_chain(x_in).permute(0, 2, 3, 1).float()
    if got.shape != want.shape:
        raise AssertionError(f'shapes {tuple(got.shape)} / {tuple(want.shape)}')
    scale = want.abs().max().item()
    diff = (got - want).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    ok = (err <= OSA_PATH_TOL['max_share'] * scale
          and mean_err <= OSA_PATH_TOL['mean_share'] * scale)
    log(f'  input {tuple(x_in.shape)} {x_in.dtype} -> {OSA_BLOCKS} blocks, '
        f'launches {launches}; finite, halo rows and pad columns zero after '
        'every block')
    log(f'  against stage4[1:] (cuDNN): max_abs_err {err:.3e}, mean_abs_err '
        f'{mean_err:.3e}, max |x| {scale:.3e} (tol {OSA_PATH_TOL} of max '
        f'|x|): {"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError('the fused stage-4 chain disagrees with the '
                             'model')
    del outs, got, want, diff
    # 4 chains: a chain queues about a hundred launches (the model's about
    # two hundred), and a stream holds about a thousand before the host
    # must wait for the card
    chain_ms = device_ms(lambda: fused_chain(x_pad), 4)
    model_ms = device_ms(lambda: model_chain(x_in), 4)
    log(f'  device time of the {OSA_BLOCKS} blocks, gate and identity add '
        f'included (mean of 4 chains): through osa_block {chain_ms:.4f} ms, '
        f'through the model\'s modules (cuDNN) {model_ms:.4f} ms [{card}]')
    return dict(launches=launches['osa_fused'], path_err=err,
                path_mean_err=mean_err, chain_ms=chain_ms, model_ms=model_ms,
                operands=(x_pad, mask, packed[0]))


def osa_check(name, operands, sh):
    """Phase 14: the kernel against osa_reference on a model's operands (the
    tolerance of tests/_osa_cases.py), and whether two runs are bitwise
    equal."""
    got = osa_cuda.osa_fused(*operands, sh)
    torch.cuda.synchronize()
    want = osa.osa_reference(*operands, sh)
    err, terr = shared_cases('_osa_cases').assert_osa_close(got, want, sh)
    again = osa_cuda.osa_fused(*operands, sh)
    bitwise = bool(torch.equal(got[0], again[0])
                   and torch.equal(got[1], again[1]))
    log(f'  {name} x_pad {tuple(operands[0].shape)}: y max_abs_err {err:.3e} '
        f'(max |y| {want[0].float().abs().max().item():.3e}, tol 6 x 2^-8 x '
        f'max), tsum max_abs_err {terr:.3e} (max '
        f'{want[1].abs().max().item():.3e}, tol 1e-3 x max); two runs bitwise '
        f'equal: {bitwise}')
    return err, bitwise


def folded_cudnn_osa(module):
    """Yardstick: the block's function as an inference engine would fold it,
    BN scale into bf16 channels-last conv weights and BN shift into the conv
    bias, through F.conv2d and, for the 1x1 conv over the concat, one
    matmul; the ReLUs in place. Returns f(x (n, c, h, w) channels-last bf16)
    -> (y (n, h, w, cout), tsum (n, cout) f32). Never called by the port."""
    def fold(block):
        conv, bn = block[0], block[1]
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        w = (conv.weight * inv.view(-1, 1, 1, 1)).to(torch.bfloat16)
        return (w.contiguous(memory_format=torch.channels_last),
                (bn.bias - bn.running_mean * inv).to(torch.bfloat16))

    with torch.no_grad():
        convs = [fold(layer) for layer in module.layers]
        wc, bc = fold(module.concat)
        wc = wc.flatten(1).t().contiguous()              # (cin + 5*cm, cout)

    def run(x):
        feats, cur = [x], x
        for w, b in convs:
            cur = F.relu_(F.conv2d(cur, w, b, padding=1))
            feats.append(cur)
        cat = torch.cat(feats, dim=1).permute(0, 2, 3, 1)    # NHWC view
        n, h, wd, c = cat.shape
        y = F.relu_(torch.addmm(bc, cat.reshape(-1, c), wc)).view(n, h, wd, -1)
        return y, y.sum(dim=(1, 2), dtype=torch.float32)
    return run


def unfused_module_osa(module):
    """The model's own chain up to the gate: conv, then the frozen BN as a
    bf16 multiply and add, then ReLU, six times, with the concat."""
    def run(x):
        feats = [x]
        for layer in module.layers:
            x = layer(x)
            feats.append(x)
        return module.concat(torch.cat(feats, dim=1))
    return run


def osa_times(module, x_in, operands, sh, card):
    """Phase 15: device times of one stage-4 block and its bound."""
    x_pad, mask, weights = operands
    n = x_pad.shape[0]
    h, w, cin, cm, cout = (sh[k] for k in ('h', 'w', 'cin', 'cm', 'cout'))
    macs_per_pixel = 9 * cin * cm + 4 * 9 * cm * cm + (cin + 5 * cm) * cout
    flops = 2 * n * h * w * macs_per_pixel
    padded_flops = 2 * n * h * sh['wp'] * macs_per_pixel
    y, tsum = osa_cuda.osa_fused(*operands, sh)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x_pad, mask, y, tsum, *weights.values()))
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    library, unfused = folded_cudnn_osa(module), unfused_module_osa(module)
    t = dict(
        ms=device_ms(lambda: osa_cuda.osa_fused(*operands, sh), 30),
        cold=cold_l2_ms(lambda: osa_cuda.osa_fused(*operands, sh), 20),
        plain_ms=device_ms(lambda: osa.osa_reference(*operands, sh), 3),
        library_ms=device_ms(lambda: library(x_in), 30),
        unfused_ms=device_ms(lambda: unfused(x_in), 30),
        bound_ms=bound_ms, bound_by=bound_by)
    y_ref = osa.unpad_plane(y, h, w, sh['wp']).float()
    scale = y_ref.abs().max().item()
    lib_err = (library(x_in)[0].float() - y_ref).abs().max().item()
    unf_err = (unfused(x_in).permute(0, 2, 3, 1).float()
               - y_ref).abs().max().item()
    log(f'  osa_fused {t["ms"]:.4f} ms warm L2 (mean of 30 back-to-back), '
        f'{t["cold"]:.4f} ms after an L2 flush (median of 20), '
        f'{flops / t["ms"] / 1e9:.1f} TFLOP/s; plain (osa_reference, f32 '
        f'matmuls) {t["plain_ms"]:.4f} ms [{card}]')
    log(f'  folded cuDNN chain + one matmul {t["library_ms"]:.4f} ms (its '
        f'max_abs_err against the kernel {lib_err:.3e}); the model\'s unfused '
        f'conv / BN / ReLU chain {t["unfused_ms"]:.4f} ms (max_abs_err '
        f'{unf_err:.3e}); max |y| {scale:.3e} [{card}]')
    log(f'  bound {bound_ms:.4f} ms ({bound_by}): {flops / 1e9:.1f} GFLOP '
        f'bf16 at 989 TFLOP/s = {flops / BF16_FLOPS_PER_S * 1e3:.4f} ms over '
        f'the {n * h * w} real pixels ({padded_flops / 1e9:.1f} GFLOP = '
        f'{padded_flops / BF16_FLOPS_PER_S * 1e3:.4f} ms over the '
        f'{n * h * sh["wp"]} padded rows the kernel computes); '
        f'{nbytes / 1e6:.2f} MB at 3.35 TB/s = '
        f'{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms')
    return t


def states_equal(a, b):
    """Whether two train states are bitwise equal: step, every parameter and
    buffer, and each parameter's Adam step count and both moments."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict()['state'], b.optimizer.state_dict()['state']
    return (a.step == b.step and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and oa.keys() == ob.keys() and len(oa) > 0
            and all(torch.equal(oa[i][k], ob[i][k]) for i in oa
                    for k in ('step', 'exp_avg', 'exp_avg_sq')))


class TimedFrames:
    """An eval loader whose frames are stamped with the host clock as
    run_inference asks for them; the gaps are the eval loop's ms a frame."""

    def __init__(self, loader):
        self.loader, self.pad, self.stamps = loader, loader.pad, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for frame in self.loader:
            self.stamps.append(time.perf_counter())
            yield frame


def host_pipeline_ms(dataset, cfg, frames):
    """Host ms of process_frame (decode, warp, GT, depth painting) a
    7-camera frame on one loader thread, and of its warps, each the median
    over `frames` training frames."""
    warp_s = []
    real_warp = pipeline.warp_affine_inverse

    def timed_warp(*args):
        t0 = time.perf_counter()
        out = real_warp(*args)
        warp_s[-1] += time.perf_counter() - t0
        return out

    total, warp = [], []
    pipeline.warp_affine_inverse = timed_warp
    try:
        for i in range(frames):
            warp_s.append(0.0)
            t0 = time.perf_counter()
            pipeline.process_frame(dataset.get_frame(i), cfg,
                                   np.random.default_rng(i), train=True)
            total.append((time.perf_counter() - t0) * 1e3)
            warp.append(warp_s[-1] * 1e3)
    finally:
        pipeline.warp_affine_inverse = real_warp
    return statistics.median(total), statistics.median(warp)


def dataset_path(cfg, dev, card, workdir):
    """Phase 16: the dataset-to-metric path at `cfg`'s width. Writes the
    full-size learnable dataset (DATA_SCENES x DATA_FRAMES frames of 7
    native AV2 cameras, PNG), trains DATA_STEPS steps from TrainLoader
    through run_training across the GT-depth switch with a save at the
    interval and a forced one at the end, restores the last checkpoint into
    a fresh state and holds it bitwise against the live one, resumes to
    DATA_RESUME_STEPS, and evaluates every frame through EvalLoader,
    run_inference (uint8 frames uploaded ahead) and collect_and_evaluate."""
    ann = str(workdir / 'infos.pkl')
    t0 = time.perf_counter()
    make_learnable_dataset_fullsize(ann, str(workdir), n_scenes=DATA_SCENES,
                                    frames_per_scene=DATA_FRAMES)
    n_frames = DATA_SCENES * DATA_FRAMES
    log(f'  wrote {n_frames} frames x 7 cameras (2048x1550 front, 1550x2048 '
        f'others, PNG) in {time.perf_counter() - t0:.1f} s')
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, use_gt_depth_until_iter=DATA_GT_DEPTH_UNTIL,
        checkpoint_every=DATA_SAVE_EVERY, log_every=1, keep_checkpoints=1))
    train_ds = AV2SequenceDataset(ann, str(workdir))
    pipe_ms, warp_ms = host_pipeline_ms(train_ds, cfg, n_frames)
    log(f'  loader host work: {pipe_ms:.1f} ms a 7-camera frame on one '
        f'thread (median of {n_frames}), of which the warp {warp_ms:.1f} ms '
        f'[{card}]')

    steps, saves = [], []
    real_step, real_save = runner.train_step, CheckpointManager.save

    def recording_step(cfg, state, *args, use_gt_depth):
        steps.append((state.step, use_gt_depth))
        return real_step(cfg, state, *args, use_gt_depth=use_gt_depth)

    save_s = []

    def recording_save(self, step, state, force=False):
        t0 = time.perf_counter()
        wrote = real_save(self, step, state, force)
        if wrote:
            saves.append((step, force))
            save_s.append(time.perf_counter() - t0)
        return wrote

    work = workdir / 'work'
    loader = TrainLoader(train_ds, cfg, 1, num_threads=8)
    runner.train_step, CheckpointManager.save = recording_step, recording_save
    names = (msda_cuda.FWD, msda_cuda.DVAL, msda_cuda.DATTN)
    torch.cuda.reset_peak_memory_stats()
    try:
        _build.reset_launch_counts()
        state = runner.run_training(cfg, loader, str(work), 1, resume=False,
                                    max_iters=DATA_STEPS)
        torch.cuda.synchronize()
        lines = [json.loads(x) for x in
                 (work / 'metrics.jsonl').read_text().splitlines()]
        want_steps = [(i, i < DATA_GT_DEPTH_UNTIL) for i in range(DATA_STEPS)]
        if steps != want_steps:
            raise AssertionError(f'steps (index, GT depth) {steps}, expected '
                                 f'{want_steps}')
        if len(lines) != DATA_STEPS or not all(
                np.isfinite(list(m.values())).all() for m in lines):
            raise AssertionError(f'metrics.jsonl: {lines}')
        want_saves = [(1, False), (DATA_SAVE_EVERY, False), (DATA_STEPS, True)]
        kept = CheckpointManager(str(work)).all_steps()
        if saves != want_saves or kept != [DATA_STEPS]:
            raise AssertionError(f'saves {saves} (expected {want_saves}), '
                                 f'kept {kept}')
        ckpt_gb = (work / f'{DATA_STEPS}.pt').stat().st_size / 1e9
        log(f'  {DATA_STEPS} steps, GT depth for steps 0..'
            f'{DATA_GT_DEPTH_UNTIL - 1}; saved (step, forced) {saves}, kept '
            f'{kept}; total_loss {lines[0]["total_loss"]:.4f} -> '
            f'{lines[-1]["total_loss"]:.4f}; a checkpoint {ckpt_gb:.3f} GB, '
            f'saved in {", ".join(f"{t:.2f}" for t in save_s)} s [{card}]')

        fresh, _ = create_train_state(cfg, build_model(
            cfg, dev, weights=init_state_dict(cfg, cfg.train.seed + 1)))
        CheckpointManager(str(work)).restore(fresh)
        if not states_equal(fresh, state):
            raise AssertionError('the restored state differs from the live one')
        del fresh
        log(f'  step {DATA_STEPS} restored into a fresh state: every parameter '
            'and buffer, both Adam moments and the step bitwise equal')

        steps.clear()
        state = runner.run_training(cfg, loader, str(work), 1, resume=True,
                                    max_iters=DATA_RESUME_STEPS)
        torch.cuda.synchronize()
        resumed = [i for i, _ in steps]
        if resumed != list(range(DATA_STEPS, DATA_RESUME_STEPS)) or \
                state.step != DATA_RESUME_STEPS:
            raise AssertionError(f'resume ran steps {resumed} to {state.step}')
        train_launches = {k: _build.launch_counts[k] for k in names}
        want = LAYERS_PER_FRAME * DATA_RESUME_STEPS
        if any(v != want for v in train_launches.values()):
            raise AssertionError(f'training launches {train_launches}, '
                                 f'expected {want} of each')
        log(f'  resumed at step {DATA_STEPS}, ended at {state.step}; launches '
            f'in {DATA_RESUME_STEPS} steps {train_launches}')
        # the same steps with the loader idle: batches taken from it first
        batches = list(itertools.islice(iter(loader), DATA_IDLE_STEPS))
        loader.stop()
        state = runner.run_training(cfg, iter(batches), str(work), 1,
                                    resume=True, max_iters=DATA_RESUME_STEPS
                                    + DATA_IDLE_STEPS)
        torch.cuda.synchronize()
    finally:
        runner.train_step, CheckpointManager.save = real_step, real_save
        loader.stop()
    lines = [json.loads(x) for x in
             (work / 'metrics.jsonl').read_text().splitlines()]
    ms_step = statistics.median(m['time'] * 1e3 for m in lines[2:DATA_STEPS])
    wait_ms = statistics.median(m['data_time'] * 1e3
                                for m in lines[2:DATA_STEPS])
    idle_ms = statistics.median(m['time'] * 1e3
                                for m in lines[DATA_RESUME_STEPS + 1:])
    log(f'  run_training: {ms_step:.2f} ms/step (median of steps 2..'
        f'{DATA_STEPS - 1}), of which waiting on the loader\'s queue '
        f'{wait_ms:.2f} ms (median) [{card}]; by step, ms (wait): '
        + ', '.join(f'{m["time"] * 1e3:.1f} ({m["data_time"] * 1e3:.1f})'
                    for m in lines))
    log(f'  the same steps with the loader idle (batches taken from it '
        f'first): {idle_ms:.2f} ms/step (median of steps '
        f'{DATA_RESUME_STEPS + 1}..{DATA_RESUME_STEPS + DATA_IDLE_STEPS - 1}) '
        f'[{card}]')

    eval_ds = AV2SequenceDataset(ann, str(workdir), split='val',
                                 seq_split_num=1)
    frames = TimedFrames(EvalLoader(eval_ds, cfg, num_threads=8))
    _build.reset_launch_counts()
    results = run_inference(cfg, state.model, frames)
    torch.cuda.synchronize()
    eval_launches = _build.launch_counts[msda_cuda.FWD]
    if len(results) != n_frames or eval_launches != LAYERS_PER_FRAME * n_frames:
        raise AssertionError(f'eval: {len(results)} frames, {eval_launches} '
                             f'msda_fwd launches')
    _, means = collect_and_evaluate(cfg, eval_ds, str(workdir / 'results'),
                                    0, 1, results)
    if not all(np.isfinite(v) for v in means.values()):
        raise AssertionError(f'eval metrics not finite: {means}')
    gaps = np.diff(frames.stamps) * 1e3
    eval_ms = statistics.median(gaps[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'  eval over {len(results)} frames: mAP {means["mAP"]:.4f}, CDS '
        f'{means["CDS"]:.4f}; {eval_ms:.2f} ms/frame with the upload (median '
        f'of frames 2..{n_frames - 1}); msda_fwd launches {eval_launches}; '
        f'peak memory {peak:.2f} GiB [{card}]')
    return dict(train_launches=train_launches, eval_launches=eval_launches,
                ms_step=ms_step, wait_ms=wait_ms, idle_ms=idle_ms,
                eval_ms=eval_ms, ckpt_gb=ckpt_gb, save_s=save_s,
                pipe_ms=pipe_ms, warp_ms=warp_ms, peak_gib=peak,
                mAP=means['mAP'], CDS=means['CDS'])


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

    log('== phase 2: build every kernel source')
    t0 = time.perf_counter()
    _build.build_all()
    log(f'  {", ".join(f"{src}.cu" for src in _build.SOURCES)} built in '
        f'parallel and loaded in {time.perf_counter() - t0:.2f} s')
    for src in _build.SOURCES:
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
    backbone = step.model.img_backbone
    stage3, stage4 = backbone.stage3, backbone.stage4
    osa_inputs = {}
    osa_hooks = [
        block.register_forward_pre_hook(
            lambda module, args, key=key: osa_inputs.setdefault(
                key, args[0].detach().clone()))
        for key, block in (('OSA3_2', stage3.OSA3_2), ('OSA4_2', stage4.OSA4_2))]
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
    for h in osa_hooks:
        h.remove()
    if _build.launch_counts['osa_fused']:
        raise AssertionError('the model\'s main path must not run osa_fused')
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
        fwd_bitwise = bool(torch.equal(
            got, msda_cuda.msda_fwd(value, shapes, loc, weights)))
        log(f'  max_abs_err {max_abs_err:.3e} (tol {PROD_TOL}), output max '
            f'|x| {want.float().abs().max().item():.3e}; two runs bitwise '
            f'equal: {fwd_bitwise}')

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

    del step, state, captured, dets, value, loc, weights, got, want, backbone
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
    del train['operands'], check['ref'], value, loc, weights, grad_out
    torch.cuda.empty_cache()

    log('== phase 12: osa_fused vs plain, small and awkward shapes')
    with torch.inference_mode():
        osa_small_shapes(dev)

        log('== phase 13: the third path, stage 4 of the full-width backbone '
            'through osa_fused')
        sh4, sh3 = osa.shapes_for_stage(4), osa.shapes_for_stage(3)
        x4, x3 = osa_inputs['OSA4_2'], osa_inputs['OSA3_2']
        path = osa_main_path(stage4, x4, sh4, card)

        log('== phase 14: osa_fused vs plain on the model\'s operands')
        osa_err, osa_bitwise = osa_check('OSA4_2', path['operands'], sh4)
        operands3 = (nhwc_plane(x3, sh3['wp']),
                     osa.interior_mask(sh3['h'], sh3['w'], sh3['wp'], device=dev),
                     osa.pack_osa_weights(stage3.OSA3_2))
        osa_err3, osa_bitwise3 = osa_check('OSA3_2', operands3, sh3)
        del operands3

        log('== phase 15: times of one stage-4 block')
        osa_t = osa_times(stage4.OSA4_2, x4, path['operands'], sh4, card)

    path.pop('operands')
    del x4, x3, osa_inputs, stage3, stage4
    torch.cuda.empty_cache()

    log('== phase 16: the dataset path: disk -> TrainLoader -> run_training '
        '-> checkpoint, restore, resume -> EvalLoader -> run_inference -> AV2 '
        'metrics')
    with tempfile.TemporaryDirectory(prefix='far3d_data_') as tmp:
        data = dataset_path(cfg, dev, card, Path(tmp))
    torch.cuda.empty_cache()

    common = {'route': 'cuda', 'ms_per_frame': ms_frame, 'ms_per_step': ms_step,
              'peak_gib_train': train['peak_gib']}
    bwd_plain = 'msda_backward_reference: autograd through msda_reference, f32'
    bwd_lib = 'backward of F.grid_sample per level + einsum (composite, f32)'
    kernels = {'kernels': [{
        'name': 'msda_fwd', **common,
        'source': 'far3d_tpu_torch/csrc/msda_fwd.cu',
        'replaces': 'far3d_tpu/ops/msda_pallas.py:150',
        'launches': launches, 'train_launches': train_launches['msda_fwd'],
        'dataset_train_launches': data['train_launches']['msda_fwd'],
        'dataset_eval_launches': data['eval_launches'],
        'max_abs_err': max_abs_err, 'train_max_abs_err': train_fwd_err,
        'bitwise_repeatable': fwd_bitwise,
        'ms': kernel_ms, 'kernel_ms': kernel_ms,
        'ms_cold_l2': kernel_cold_ms, 'plain_ms': plain_ms,
        'train_ms': times['fwd_ms'], 'train_ms_cold_l2': times['fwd_cold'],
        'train_bound_ms': times['fwd_bound'],
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
        'dataset_train_launches': data['train_launches']['msda_dval'],
        'max_abs_err': errs['d_value'],
        'bitwise_repeatable': check['dval_bitwise'],
        'ms_by_launch': {k[:80]: v for k, v in times['dval_parts']},
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
        'dataset_train_launches': data['train_launches']['msda_dattn'],
        'max_abs_err': max(errs['d_loc'], errs['d_weights']),
        'bitwise_repeatable': check['dattn_bitwise'],
        'ms': times['dattn_ms'], 'kernel_ms': times['dattn_ms'],
        'ms_cold_l2': times['dattn_cold'],
        'plain_ms': times['plain_ms'], 'plain': bwd_plain,
        'bound_ms': times['dattn_bound'], 'bound_by': times['dattn_by'],
        'library_ms': times['dattn_library_ms'],
        'library': 'backward of F.grid_sample per level + einsum (composite, '
                   'f32), loc and weights gradients only',
        'library_all_grads_ms': times['library_ms'],
    }, {
        'name': 'osa_fused', **common,
        'source': 'far3d_tpu_torch/csrc/osa_fused.cu',
        'replaces': 'tools/dev_micro_osa_pallas.py:59',
        'launches': path['launches'],
        'max_abs_err': osa_err, 'stage3_max_abs_err': osa_err3,
        'path_max_abs_err': path['path_err'],
        'bitwise_repeatable': osa_bitwise and osa_bitwise3,
        'ms': osa_t['ms'], 'kernel_ms': osa_t['ms'],
        'ms_cold_l2': osa_t['cold'],
        'plain_ms': osa_t['plain_ms'],
        'plain': 'osa_reference: shifted f32 matmuls of the bf16 operands',
        'bound_ms': osa_t['bound_ms'], 'bound_by': osa_t['bound_by'],
        'library_ms': osa_t['library_ms'],
        'library': 'BN folded into bf16 channels-last F.conv2d x5 + one '
                   'addmm over the concat',
        'unfused_module_ms': osa_t['unfused_ms'],
        'stage4_chain_ms': path['chain_ms'],
        'stage4_model_chain_ms': path['model_ms'],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
