#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (far3d_tpu_torch) on one NVIDIA card:
Far3D (phases 1-17), StreamPETR (phase 18), data parallelism and camera
sharding (phase 19).

    python3 chip_smoke.py

Phases, each raising on failure:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel source of the port (far3d_tpu_torch/csrc/msda_fwd.cu,
     msda_bwd.cu, osa_fused.cu, qconv.cu, ese_requant.cu), one nvcc each,
     all started together;
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
     ms/step and the wait on the loader, eval ms/frame and peak memory;
 17. the fifth main path, int8 serving at full width: both int8 conv
     kernels of csrc/qconv.cu (the TMA + wgmma one and the first mma.sync
     one) bitwise against their plain version at the shapes and channel
     slices of tests/_qconv_cases.py, every TMA tile forced once, and the
     OSA block tail (csrc/ese_requant.cu) bitwise against its plain version;
     Far3DConfig() with seeded weights, its backbone calibrated on 2 frames
     and quantized, 8 streaming frames through quant_backbone (98 qconv_tma,
     1 qconv_mma, 16 ese_requant and 6 msda_fwd launches a frame), ms/frame
     int8, bf16, int8 in turn; the stage outputs' relative L2 error against
     the bf16 backbone on a held-out frame; the kernels bitwise against
     their plain version on the operands of all 99 conv sites of a frame as
     the model passes them (channel slices of the blocks' concat buffers),
     the routes counted (98 TMA, 1 mma.sync); per class of sites the
     kernel's device ms (warm and cold L2), the first version's, its bound,
     the plain version, an im2col + torch._int_mm composite and the bf16
     cuDNN conv (yardsticks, never called by the port), summed over the
     frame; the 16 block tails against their plain version (bitwise), two
     runs bitwise equal, and against the PyTorch sequence they replace (no
     element more than 1 apart, at least 99.99% equal), with their device
     ms, bytes bound and the sequence's ms; both backbones' device busy ms
     (torch.profiler); then phase 16's eval again through cli.test --quant
     --submission on its checkpoint, with a drivable-area map per scene
     written beside the dataset, with the ROI gate (--map-root) and
     without: mAP, CDS, the GT boxes counted, the submission's rows read
     back from the file's footer;
 18. the StreamPETR family at full StreamPETRConfig() width (VoVNet-99, 6
     cameras of 320x800, 644 + 128 queries, 512 memory slots, 6 layers),
     seeded weights: (a) 8 streaming frames through petr_entry with the
     bf16 backbone (no kernel of the port launched), then the same 8 with
     the int8 backbone (quantize_petr_backbone on 2 other frames; 98
     qconv_tma, 1 qconv_mma and 16 ese_requant launches a frame), ms/frame
     of each (median of frames 2..7), finite detections, the stages'
     relative L2 error int8 against bf16 on a held-out frame; (b) qconv
     bitwise against its plain version on all 99 conv sites as the model
     passes them (98 TMA required; sites whose operands the TMA kernel
     does not take are printed with their row pitch), the kernel's ms per
     class of sites warm and cold with its bound, and the 16 block tails of
     ese_requant bitwise with their ms against the bytes bound; both
     backbones' device busy ms (torch.profiler) and a whole bf16 frame's;
     (c) decoder layer 0's cross attention (772 x 6,000 keys, 8 heads of
     32, bf16): scaled_dot_product_attention against the JAX package's
     einsum + f32 softmax form (yardstick), their max difference and device
     ms; (d) 6 full-width training steps through petr_train_entry (grid
     mask, dropout, bf16 images): ms/step (median of steps 2..5), peak
     memory, finite losses and grad norm, Adam's moment moved for every
     parameter with a gradient, the pseudo reference points unchanged;
     (e) a learnable nuScenes dataset of 2 scenes x 4 frames, 2 cameras of
     PNG at 320x800, in a temporary directory through cli.train_nusc (4
     steps, a checkpoint) and cli.test_nusc on it, bf16 and --quant:
     finite mAP and NDS;
 19. data parallelism and camera sharding (far3d_tpu_torch/parallel/),
     each rank a process of this script (--rank-worker) with a time limit,
     a failed rank stopping the others: (a) run_training at full width for
     3 steps under NCCL at world size 1 (torchrun's variables) against the
     same run without a group, step 0 bitwise, the gradient MiB
     all-reduced a step, 6 launches of each MSDA kernel a step; (b) two
     gloo ranks sharing this card at full width, a lane each of a batch of
     two, 3 steps: a sha256 of each rank's parameters and buffers equal
     after every step, finite losses, ms/step and the all-reduces' share
     (two ranks on one card: no scaling number), peak memory, 6 launches of
     each MSDA kernel a step a rank; (c) the tiny Far3D and StreamPETR
     steps, f32 without dropout, two gloo ranks at batch 1 against one
     process at batch 2 on the card (TINY_TOL, Adam moments, parameters, BN
     statistics); (d) cli.test on two gloo ranks against one process on
     phase 16's dataset and checkpoint: the parts' frame order, mAP and
     CDS equal; (e) make_cam_sharded_infer over [cuda:0] x 7 against the
     unsharded frame: two f32 frames held at CAM_TOL, then bf16 frames
     timed, the FPN output held at CAM_FPN_TOL, 6 msda_fwd launches a
     sharded frame.
 20. training at deployment scale: (a) the matching of one full-width
     Far3D step (train_entry, synthetic_batch(cfg, 1, 0): 6 decoder
     layers of 1156 x 160 and the DN cost) and one StreamPETR step
     (petr_train_entry): host ms of scipy's exact solver (lsa_host, the
     port's matching before the auction) and of the auction (its
     CHECK_EVERY-iteration chunks replayed from a CUDA graph, and launched
     op by op for comparison), its iterations, the auction on the card
     bitwise equal to the auction on the CPU on the same costs, its total
     cost within MATCH_GAP of scipy's optimum on every problem, and ms/step
     of both families with each matcher, alternating; (b) cli.soak at full
     width cut in depth (resume checks over SOAK_RESUME steps, both
     bitwise; SOAK_ITERS steps across the GT-depth switch at SOAK_SWITCH,
     finite windows; step 0's gradient norm and its carriers; 6 launches
     of each MSDA kernel a step); (c) cli.overfit_full's
     run_closed_loop_full at full width, CLOSED_STEPS steps with the
     switch halfway and one evaluation through EvalLoader, run_inference
     and the AV2 metrics: finite mAP and CDS, 6 launches of each MSDA
     kernel a step (msda_fwd also 6 an eval frame).
Then it prints a JSON line of phase 18's other readings, one of phase 19's,
one of phase 20's, one JSON line of kernels and, last, the device line.
It exits non-zero without printing a result when no card is present.

TF32 is switched off for matmuls and cuDNN convolutions, so that every f32
comparison here is a full-f32 one; the main path's image side is bf16.
"""

import dataclasses
import hashlib
import importlib
import itertools
import json
import os
import pickle
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from far3d_tpu_torch.cli import overfit_full as cli_overfit_full
from far3d_tpu_torch.cli import soak as cli_soak
from far3d_tpu_torch.cli import test as cli_test
from far3d_tpu_torch.cli import test_nusc as cli_test_nusc
from far3d_tpu_torch.cli import train_nusc as cli_train_nusc
from far3d_tpu_torch.config import Far3DConfig, TrainConfig, tiny_test_config
from far3d_tpu_torch.data import pipeline
from far3d_tpu_torch.data.av2_dataset import AV2SequenceDataset
from far3d_tpu_torch.data.loader import EvalLoader, TrainLoader
from far3d_tpu_torch.entry import (build_model, build_petr_model, entry,
                                   petr_entry, petr_train_entry, run_frame,
                                   train_entry)
from far3d_tpu_torch.eval.runner import collect_and_evaluate, run_inference
from far3d_tpu_torch.models.farhead import init_state
from far3d_tpu_torch.models.streampetr import (StreamPETRConfig,
                                               init_petr_state,
                                               tiny_petr_config)
from far3d_tpu_torch.ops import (_build, ese_requant_cuda, msda_cuda, osa,
                                 osa_cuda, qconv_cuda, quant)
from far3d_tpu_torch.ops.msda import (_corner_data, msda,
                                      msda_backward_reference, msda_reference)
from far3d_tpu_torch.ops.qconv import (out_size, qconv_reference,
                                       requant_epilogue)
from far3d_tpu_torch.parallel import mesh
from far3d_tpu_torch.parallel.cam_shard import make_cam_sharded_infer
from far3d_tpu_torch.train.step import (create_train_state, draw_step_noise,
                                        make_infer_step, step_from_noise,
                                        train_step)
from far3d_tpu_torch.train import dn as dn_mod
from far3d_tpu_torch.train import losses3d, matching, runner
from far3d_tpu_torch.train.petr_step import (create_petr_train_state,
                                             draw_petr_noise,
                                             petr_step_from_noise)
from far3d_tpu_torch.utils.checkpoint import CheckpointManager
from far3d_tpu_torch.utils.convert import (init_state_dict,
                                           petr_init_state_dict,
                                           random_reference_state_dict)
from far3d_tpu_torch.utils.feather import num_rows
from far3d_tpu_torch.utils.synthetic import (inference_inputs,
                                             make_learnable_dataset_fullsize,
                                             make_learnable_nusc_dataset,
                                             petr_inference_inputs,
                                             petr_synthetic_batch,
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
SERVE_FRAMES = 8               # int8 streaming frames of phase 17
CALIB_FRAMES = 2               # its calibration frames
QCONV_PER_FRAME = 99           # 3 stem convs + 16 OSA blocks x (5 + concat)
QCONV_TMA_PER_FRAME = 98       # all but the stem's first conv (ci = 3)
BLOCKS_PER_FRAME = 16          # OSA blocks: one ese_requant each
QUANT_REL_L2 = 0.08            # tests/test_quant.py:88-91, printed beside
PETR_FRAMES = 8                # StreamPETR streaming frames of phase 18
PETR_STEPS = 6                 # its full-width training steps
PETR_DATA_STEPS = 4            # cli.train_nusc steps from its PNG dataset
PETR_DATA_HW = (320, 800)      # its cameras: the model's input, no resize
NCCL_STEPS = 3                 # run_training steps under NCCL at world 1
DP_STEPS = 3                   # full-width steps of each of two gloo ranks
CAM_FRAMES = 6                 # camera-sharded frames, and as many unsharded
RANK_TIMEOUT_S = 600           # a phase-19 process's limit
MATCH_STEPS = 8                # phase 20a: steps with each matcher, in turn
SOAK_RESUME, SOAK_ITERS, SOAK_SWITCH = 8, 30, 15   # phase 20b: cli.soak
CLOSED_STEPS = 40              # phase 20c: closed-loop steps, then one eval
MATCH_GAP = 5e-3               # phase 20a: the auction's cost over scipy's
# Phase 19e: the seven one-camera slices run the towers at batch 1, the
# unsharded frame at batch 7, so cuDNN may take other algorithms and sum in
# another order. With f32 images the detections and the carried state are
# held at tests/test_cam_shard.py's tolerances (the largest difference
# against atol + rtol x the largest entry), matched where ties may reorder
# them (match_frames); with bf16 images, the FPN output (largest difference
# over largest entry).
CAM_TOL = dict(scores=(1e-4, 1e-4), boxes=(1e-3, 1e-3),
               embedding=(1e-4, 1e-4), ref_points=(1e-3, 1e-3))  # rtol, atol
CAM_FPN_TOL = 5e-2
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
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 on the tensor cores
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
    moved, n = hold_card_to_cpu(results)
    mg, mc = results['cuda'][0], results['cpu'][0]
    log(f'  tiny train step card vs CPU: {len(mc[0])} metrics x 2 steps '
        f'(tol {TINY_TOL}), Adam first moments of {n[0]} parameters '
        f'({moved} with a gradient, each moved on the card; rtol 1e-3, atol '
        f'2e-3 x max |m|), {n[1]} parameters and buffers (tol {TINY_TOL}) '
        f'agree; total_loss {mg[0]["total_loss"]:.4f} -> '
        f'{mg[1]["total_loss"]:.4f}, grad_norm {mg[0]["grad_norm"]:.3f}')


def hold_card_to_cpu(results, moment_floor=1e-12):
    """Hold a card's tiny training run to the CPU's: results[device type] =
    (metrics of each step, state dict after them, Adam first moments, the
    parameters before them); a moment's atol is 2e-3 of its tensor's
    largest, at least `moment_floor`. Returns (parameters with a gradient,
    (number of moments, number of state-dict entries))."""
    return hold_run(results['cuda'], results['cpu'], moment_floor)


def hold_run(got, want, moment_floor=1e-12):
    """Hold a tiny training run `got` to `want` (each: metrics of each step,
    state dict after them, Adam first moments, the parameters before them)
    as ``hold_card_to_cpu`` describes."""
    (mg, sg, ag, before), (mc, sc, ac, _) = got, want
    for i, (a, b) in enumerate(zip(mg, mc)):
        for k in b:
            torch.testing.assert_close(
                torch.tensor(a[k]), torch.tensor(b[k]), **TINY_TOL,
                msg=lambda m, k=k: f'step {i} {k}: {m}')
    moved = 0
    for k, want in ac.items():
        scale = want.abs().max().item()
        torch.testing.assert_close(ag[k], want, rtol=1e-3,
                                   atol=max(2e-3 * scale, moment_floor),
                                   msg=lambda m, k=k: f'exp_avg {k}: {m}')
        if scale > 0:
            moved += 1
            if torch.equal(before[k], sg[k]):
                raise AssertionError(f'{k} has a gradient but did not move')
    if moved < 0.8 * len(ac):
        raise AssertionError(f'only {moved} of {len(ac)} parameters have a '
                             'gradient')
    for k in sc:
        torch.testing.assert_close(sg[k].cpu(), sc[k], **TINY_TOL,
                                   msg=lambda m, k=k: f'{k}: {m}')
    return moved, (len(ac), len(sc))


def tiny_petr_train_card_vs_cpu(dev):
    """tiny_train_card_vs_cpu for StreamPETR: two tiny f32 training steps
    without dropout on the card and on the CPU, from the same initial
    weights, batch and grid-mask draws. Its step runs no port kernel, so
    this holds the card's library numerics of the forward, the backward and
    AdamW to the CPU's: the closed loop's seed sweeps (PERF.md) compare the
    two devices, whose dropout draws differ. The moments' atol is at least
    1e-8, as in tests/test_torch_port_petr.py: the frustum PE's output bias
    and the attentions' key biases have gradients that are zero in exact
    arithmetic (the softmax cancels their equal shift of every key's score),
    so their moments are rounding noise (1e-10 to 3e-9 on the CPU)."""
    cfg = dataclasses.replace(tiny_petr_config(), dropout=0.0)
    tcfg = dataclasses.replace(TrainConfig(), lr=2e-3, warmup_iters=1,
                               dtype='float32', ema_decay=0.0)
    gen = torch.Generator().manual_seed(0)
    noises = [draw_petr_noise(cfg, tcfg, gen) for _ in range(2)]
    weights = petr_init_state_dict(cfg, 0)
    results = {}
    for device in (dev, torch.device('cpu')):
        state, tstate = create_petr_train_state(
            build_petr_model(cfg, device, weights=weights), tcfg)
        before = {k: p.detach().clone()
                  for k, p in state.model.named_parameters()}
        batch = {k: v.to(device)
                 for k, v in petr_synthetic_batch(cfg, 1, 6).items()}
        metrics = []
        for i, noise in enumerate(noises):
            if i:
                batch['prev_exists'] = torch.ones(1, device=device)
            state, tstate, m = petr_step_from_noise(cfg, tcfg, state, tstate,
                                                    batch, noise)
            metrics.append({k: float(v) for k, v in m.items()})
        moments = {k: state.optimizer.state.get(p, {}).get(
            'exp_avg', torch.zeros_like(p)).cpu()
            for k, p in state.model.named_parameters()}
        results[device.type] = (metrics, state.model.state_dict(), moments,
                                before)
    moved, n = hold_card_to_cpu(results, moment_floor=1e-8)
    mg = results['cuda'][0]
    log(f'  tiny StreamPETR train step card vs CPU (f32, no dropout, grid '
        f'mask on): {len(mg[0])} metrics x 2 steps (tol {TINY_TOL}), Adam '
        f'first moments of {n[0]} parameters ({moved} with a gradient, each '
        f'moved on the card), {n[1]} parameters and buffers agree; '
        f'total_loss {mg[0]["total_loss"]:.4f} -> '
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


def qconv_small_shapes(dev):
    """Phase 17a: both int8 conv kernels against qconv_reference, bitwise:
    the shapes of tests/_qconv_cases.py through the routing wrapper (both
    epilogues), each also through the first (mma.sync) kernel; channel
    slices in and out; every tile the TMA kernel is built for, forced; and
    the block tail against its plain version on tests/_qconv_cases.py's
    ESE_CASES, two runs bitwise equal."""
    shared = shared_cases('_qconv_cases')
    routes = {'tma': 0, 'mma': 0}
    for name, sh in sorted(shared.QCONV_SHAPES.items()):
        ops = shared.port_operands(sh, 0, dev)
        for float_out in (False, True):
            want = qconv_reference(*ops, sh['stride'], float_out)
            got = qconv_cuda.qconv_cuda(*ops, sh['stride'], float_out)
            first = qconv_cuda.qconv_mma(*ops, sh['stride'], float_out)
            torch.cuda.synchronize()
            routes[qconv_cuda.route(ops[0], ops[1], sh['stride'], got)] += 1
            if not (torch.equal(got, want) and torch.equal(first, want)):
                raise AssertionError(f'qconv {name} float_out={float_out}: '
                                     'not bitwise equal to the plain version')
    for name, sh in sorted(shared.QCONV_SLICES.items()):
        for float_out in (False, True):
            x, w, a, b, out_buf, out = shared.slice_operands(sh, 0, dev,
                                                             float_out)
            qconv_cuda.qconv_cuda(x, w, a, b, sh['stride'], float_out,
                                  out=out)
            torch.cuda.synchronize()
            routes[qconv_cuda.route(x, w, sh['stride'], out)] += 1
            rest = torch.cat([out_buf[..., :sh['out_off']],
                              out_buf[..., sh['out_off'] + sh['co']:]], -1)
            if not (torch.equal(out, qconv_reference(
                    x, w, a, b, sh['stride'], float_out))
                    and bool((rest == shared.SENTINEL).all())):
                raise AssertionError(f'qconv slices {name} float_out='
                                     f'{float_out}: not bitwise equal, or '
                                     'written outside its slice')
    plans = 0
    for (wgs, float_out), widths in sorted(qconv_cuda.TMA_WIDTHS.items()):
        for bn in widths:
            sh = dict(n=2, h=7, w=11, ci=224, co=bn + 16, k=3, stride=1)
            ops = shared.port_operands(sh, 3, dev)
            bw, bh = qconv_cuda.spatial_box(7, 11, 64 * wgs)
            plan = qconv_cuda.TmaPlan(wgs, bn, bw, bh,
                                      -(-11 // bw) * -(-7 // bh))
            got = qconv_cuda.qconv_tma(*ops, 1, float_out, plan=plan)
            torch.cuda.synchronize()
            if not torch.equal(got, qconv_reference(*ops, 1, float_out)):
                raise AssertionError(f'qconv_tma {plan} float_out='
                                     f'{float_out}: not bitwise equal')
            plans += 1
    log(f'  {len(shared.QCONV_SHAPES)} shapes x 2 epilogues and '
        f'{len(shared.QCONV_SLICES)} slice cases x 2: both kernels bitwise '
        f'equal to the plain version (routed: {routes["tma"]} TMA, '
        f'{routes["mma"]} mma.sync); all {plans} TMA tiles forced, bitwise '
        'equal')
    for name, case in sorted(shared.ESE_CASES.items()):
        y, gate, r_out, x_id, s_id, out_buf, out = shared.ese_operands(
            case, 0, dev)
        got = quant.ese_requant(y, gate, r_out, x_id, s_id, out)
        again = quant.ese_requant(y, gate, r_out, x_id, s_id)
        torch.cuda.synchronize()
        want = quant.ese_requant_reference(y, gate, r_out, x_id, s_id)
        if not (torch.equal(got, want) and torch.equal(again, got)):
            raise AssertionError(f'ese_requant {name}: not bitwise equal to '
                                 'the plain tail, or not repeatable')
    log(f'  ese_requant on {len(shared.ESE_CASES)} cases: bitwise equal to '
        'the plain tail, two runs bitwise equal')


def qconv_site_names(bcfg):
    """The JAX package's names of the backbone's conv sites, in the order
    quant_vovnet_forward calls them."""
    names = ['stem1', 'stem2', 'stem3']
    for si, blocks in enumerate(bcfg.blocks_per_stage):
        for bi in range(blocks):
            block = f'stage{si + 2}_block{bi}'
            names += [f'{block}/layer{li}'
                      for li in range(bcfg.layers_per_block)]
            names.append(f'{block}/concat')
    return names


def record_sites(fn):
    """Run `fn` once with ops.quant's qconv and ese_requant wrapped; returns
    the operands of every call of each, in call order: qconv's (x, w, a, b,
    stride, float_out, out, channel_sums), ese_requant's (y, gate, r_out,
    x_id, s_id, out)."""
    sites, tails = [], []
    real_conv, real_tail = quant.qconv, quant.ese_requant

    def conv(x, w, a, b, stride=1, float_out=False, out=None,
             channel_sums=False):
        sites.append((x, w, a, b, stride, float_out, out, channel_sums))
        return real_conv(x, w, a, b, stride, float_out, out, channel_sums)

    def tail(y, gate, r_out, x_id=None, s_id=None, out=None):
        tails.append((y, gate, r_out, x_id, s_id, out))
        return real_tail(y, gate, r_out, x_id, s_id, out)

    quant.qconv, quant.ese_requant = conv, tail
    try:
        fn()
    finally:
        quant.qconv, quant.ese_requant = real_conv, real_tail
    return sites, tails


def like_slice(t):
    """A new buffer laid out as `t` (a contiguous tensor or a channel slice
    of a wider NHWC buffer), and its slice at the same channel offset."""
    pitch = qconv_cuda.pitch_of(t, 'out')
    off = t.storage_offset() % pitch
    buf = torch.empty((*t.shape[:3], pitch), dtype=t.dtype, device=t.device)
    return buf[..., off:off + t.shape[3]]


def int_mm_composite(x, w, a, b, stride, float_out):
    """Yardstick: the conv as an im2col (pad, k*k strided slices, one cat,
    K zero-padded to a multiple of 8) and torch._int_mm (cuBLASLt s8 x s8 ->
    s32), then the same epilogue. Never called by the port."""
    n, h, wd, ci = x.shape
    co, k = w.shape[0], w.shape[1]
    p = (k - 1) // 2
    ho, wo = out_size(h, k, stride), out_size(wd, k, stride)
    kdim = k * k * ci
    kp = -(-kdim // 8) * 8
    wm = F.pad(w.reshape(co, kdim), (0, kp - kdim)).contiguous()

    def run():
        xp = F.pad(x, (0, 0, p, p, p, p))
        cols = [xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                   dx:dx + (wo - 1) * stride + 1:stride]
                for dy in range(k) for dx in range(k)]
        if kp > kdim:
            cols.append(x.new_zeros(n, ho, wo, kp - kdim))
        acc = torch._int_mm(torch.cat(cols, dim=-1).reshape(-1, kp), wm.t())
        return requant_epilogue(acc, a, b, float_out).reshape(n, ho, wo, co)
    return run


def qconv_sites_check(sites, names):
    """Phase 17c: the kernels against their plain version, bitwise, on the
    operands of every conv site of one full-width frame as the model passes
    them (channel slices of the blocks' concat buffers, outputs into
    slices); the concat convs' channel sums within f32 rounding of the plain
    sums. Returns the launches of each kernel."""
    routes = {'tma': 0, 'mma': 0}
    for name, (x, w, a, b, stride, float_out, out, sums) in zip(names, sites):
        o2 = like_slice(out) if out is not None else None
        got = qconv_cuda.qconv_cuda(x, w, a, b, stride, float_out, o2, sums)
        torch.cuda.synchronize()
        routes[qconv_cuda.route(x, w, stride, got[0] if sums else got)] += 1
        want = qconv_reference(x, w, a, b, stride, float_out,
                               channel_sums=sums)
        ok = (torch.equal(got[0], want[0]) and torch.allclose(
            got[1], want[1], rtol=1e-5, atol=1e-3)) if sums else \
            torch.equal(got, want)
        if not ok:
            raise AssertionError(f'qconv at {name} {tuple(x.shape)} -> '
                                 f'{tuple(w.shape)}: not bitwise equal')
    log(f'  all {len(sites)} conv sites of the frame, on the operands as the '
        'model passes them: the kernels bitwise equal to the plain version '
        f'(float64 unfold on the card); routes: {routes["tma"]} TMA + wgmma, '
        f'{routes["mma"]} mma.sync')
    return routes


def qconv_site_times(sites, names, card):
    """Phase 17d: per class of identical sites, the kernel's device ms (warm
    and cold L2) on the operands as the model passes them, the first
    (mma.sync) kernel's warm ms, the bound, the plain version's, the im2col
    + _int_mm composite's and the bf16 cuDNN conv's of the same shape; and
    the sums over the frame's sites."""
    classes = {}
    for name, site in zip(names, sites):
        x, w, _, _, stride, float_out = site[:6]
        key = (tuple(x.shape), tuple(w.shape), stride, float_out)
        classes.setdefault(key, (site, []))[1].append(name)
    tot = dict(ms=0.0, cold=0.0, first_ms=0.0, plain_ms=0.0, library_ms=0.0,
               cudnn_ms=0.0, bound_ms=0.0, t_ops=0.0, t_bytes=0.0, ops=0)
    for (xs, ws, stride, float_out), (site, members) in classes.items():
        x, w, a, b, _, _, out, sums = site
        n, h, wd, ci = xs
        co, k = ws[0], ws[1]
        ho, wo = out_size(h, k, stride), out_size(wd, k, stride)
        ops = 2 * n * ho * wo * co * k * k * ci
        out_bytes = n * ho * wo * co * (4 if float_out else 1)
        nbytes = x.numel() + w.numel() + 8 * co + out_bytes
        t_ops = ops / INT8_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        o2 = like_slice(out) if out is not None else None
        kern = lambda: qconv_cuda.qconv_cuda(x, w, a, b, stride, float_out,
                                             o2, sums)
        # the first kernel as the backbone ran it before the block tail had a
        # kernel: no channel sums (the mean was a PyTorch pass of its own)
        first = lambda: qconv_cuda.qconv_mma(x, w, a, b, stride, float_out,
                                             o2)
        lib = int_mm_composite(x, w, a, b, stride, float_out)
        got = kern()[0] if sums else kern()
        route = qconv_cuda.route(x, w, stride, got)
        if not torch.equal(lib(), got):
            raise AssertionError(f'the _int_mm composite disagrees at '
                                 f'{members[0]}')
        xb = x.contiguous().permute(0, 3, 1, 2).to(torch.bfloat16)  # NHWC
        wb = w.permute(0, 3, 1, 2).to(torch.bfloat16)
        cudnn = lambda: F.conv2d(xb, wb, None, stride, (k - 1) // 2)
        t = dict(ms=device_ms(kern, 20), cold=cold_l2_ms(kern, 10),
                 first_ms=device_ms(first, 20),
                 plain_ms=device_ms(lambda: qconv_reference(
                     x, w, a, b, stride, float_out), 1),
                 library_ms=device_ms(lib, 10), cudnn_ms=device_ms(cudnn, 20),
                 bound_ms=max(t_ops, t_bytes), t_ops=t_ops, t_bytes=t_bytes,
                 ops=ops)
        for key in tot:
            tot[key] += len(members) * t[key]
        log(f'  {members[0]}{" .. " + members[-1] if len(members) > 1 else ""}'
            f' (x{len(members)}): x {xs} -> co {co}, k {k}, stride {stride}'
            f'{", f32 out" if float_out else ""}, {route}: {t["ms"]:.4f} ms '
            f'warm, {t["cold"]:.4f} cold, {ops / t["ms"] / 1e9:.1f} TOPS; '
            f'first version {t["first_ms"]:.4f}; bound {t["bound_ms"]:.4f} ('
            f'{"operations" if t_ops >= t_bytes else "bytes"}); plain '
            f'{t["plain_ms"]:.3f}; im2col + _int_mm {t["library_ms"]:.4f}; '
            f'bf16 cuDNN conv {t["cudnn_ms"]:.4f} [{card}]')
    tot['bound_by'] = 'operations' if tot['t_ops'] >= tot['t_bytes'] \
        else 'bytes'
    log(f'  the frame\'s {len(sites)} sites: qconv {tot["ms"]:.4f} ms warm, '
        f'{tot["cold"]:.4f} ms cold L2, {tot["ops"] / 1e12:.3f} T int8 '
        f'operations, {tot["ops"] / tot["ms"] / 1e9:.1f} TOPS; first version '
        f'(mma.sync on every site) {tot["first_ms"]:.4f} ms; bound '
        f'{tot["bound_ms"]:.4f} ms (operations alone {tot["t_ops"]:.4f}); '
        f'plain {tot["plain_ms"]:.2f} ms; im2col + _int_mm '
        f'{tot["library_ms"]:.4f} ms; bf16 cuDNN convs {tot["cudnn_ms"]:.4f} '
        f'ms [{card}]')
    return tot


def torch_tail(y, x_q, blk):
    """Yardstick: the block tail as the port ran it before the kernel, a
    sequence of PyTorch passes from the f32 concat output (the mean, the
    gate, the gate product, the identity add, the requantization), out of
    place. Never called by the port."""
    s = y.mean(dim=(1, 2))
    g = s @ blk['ese_w'] + blk['ese_b']
    v = y * ((g + 3.0).clamp(0.0, 6.0) / 6.0)[:, None, None, :]
    if x_q is not None:
        v = v + x_q * blk['s_id']
    return (v * blk['r_out']).round().clamp(0, 127).to(torch.int8)


def ese_tail_check_and_times(tails, q, bcfg, card):
    """Phase 17e: each of the frame's 16 block tails on its own operands:
    the kernel against its plain version on the same gate (bitwise), two
    runs bitwise equal, and against the PyTorch sequence it replaces, which
    sums the eSE mean in another order (no element more than 1 apart, at
    least 99.99% equal); device ms (warm, cold L2), the bytes bound, the
    plain version's and the sequence's ms, summed over the frame."""
    names = [f'stage{si + 2}_block{bi}'
             for si, blocks in enumerate(bcfg.blocks_per_stage)
             for bi in range(blocks)]
    if len(tails) != len(names):
        raise AssertionError(f'{len(tails)} block tails, {len(names)} blocks')
    tot = dict(ms=0.0, cold=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               nbytes=0, elems=0, diff=0)
    max_diff = 0
    for name, (y, gate, r_out, x_id, s_id, out) in zip(names, tails):
        o2 = like_slice(out) if out is not None else None
        kern = lambda: quant.ese_requant(y, gate, r_out, x_id, s_id, o2)
        got = kern().clone()
        again = kern()
        plain = quant.ese_requant_reference(y, gate, r_out, x_id, s_id)
        seq = torch_tail(y, x_id, q[name])
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and torch.equal(again, got)):
            raise AssertionError(f'ese_requant at {name}: not bitwise equal '
                                 'to the plain tail, or not repeatable')
        diff = (got.int() - seq.int()).abs()
        max_diff = max(max_diff, int(diff.max()))
        nbytes = y.numel() * 4 + (x_id.numel() if x_id is not None else 0) \
            + got.numel() + gate.numel() * 4
        t = dict(ms=device_ms(kern, 20), cold=cold_l2_ms(kern, 10),
                 plain_ms=device_ms(lambda: quant.ese_requant_reference(
                     y, gate, r_out, x_id, s_id), 5),
                 library_ms=device_ms(lambda: torch_tail(y, x_id, q[name]),
                                      5),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, nbytes=nbytes,
                 elems=got.numel(), diff=int((diff > 0).sum()))
        for key in tot:
            tot[key] += t[key]
        log(f'  {name} tail: y {tuple(y.shape)}'
            f'{", identity" if x_id is not None else ""}: ese_requant '
            f'{t["ms"]:.4f} ms warm, {t["cold"]:.4f} cold; bound '
            f'{t["bound_ms"]:.4f} (bytes); the PyTorch sequence '
            f'{t["library_ms"]:.4f}; {t["diff"]} elements 1 apart from it '
            f'[{card}]')
    share = 1.0 - tot['diff'] / tot['elems']
    if max_diff > 1 or share < 0.9999:
        raise AssertionError(f'ese_requant against the PyTorch sequence: max '
                             f'difference {max_diff}, {share:.6f} equal')
    log(f'  ese_requant, the frame\'s {len(tails)} block tails: bitwise equal '
        'to the plain tail and repeatable; against the PyTorch sequence it '
        f'replaces (the mean summed in another order) {tot["diff"]} of '
        f'{tot["elems"]} elements differ ({share:.8f} equal), none by more '
        f'than {max_diff}; '
        f'{tot["ms"]:.4f} ms warm, {tot["cold"]:.4f} ms cold L2; bound '
        f'{tot["bound_ms"]:.4f} ms ({tot["nbytes"] / 1e9:.3f} GB, bytes); '
        f'plain {tot["plain_ms"]:.4f} ms; the PyTorch sequence '
        f'{tot["library_ms"]:.4f} ms [{card}]')
    return dict(tot, equal_share=share, max_diff=max_diff)


def device_busy(fn, reps=3):
    """Device busy ms of one call of `fn` (the sum of its kernels' device
    times under torch.profiler, mean of `reps` calls), and of it the
    kernels whose name holds 'qconv' and those whose name holds
    'ese_requant'."""
    parts = launch_breakdown(fn, reps)
    total = sum(ms for _, ms in parts)
    return (total, sum(ms for name, ms in parts if 'qconv' in name),
            sum(ms for name, ms in parts if 'ese_requant' in name), parts)


def serving_path(cfg, dev, card):
    """Phase 17b, d-g: the int8 serving path at full width."""
    t0 = time.perf_counter()
    step, (state,) = entry(cfg)
    model = step.model
    infer = make_infer_step(cfg)
    calib = [torch.from_numpy(inference_inputs(cfg, seed=s)['images'])
             .to(dev, torch.bfloat16) for s in range(1, 1 + CALIB_FRAMES)]
    q = quant.quantize_detector_backbone(model, calib)
    torch.cuda.synchronize()
    log(f'  model built and its backbone calibrated on {CALIB_FRAMES} frames '
        f'and quantized in {time.perf_counter() - t0:.1f} s')
    inputs = {k: torch.from_numpy(v).to(dev)
              for k, v in inference_inputs(cfg, seed=0).items()}
    inputs['images'] = inputs['images'].to(torch.bfloat16)

    def frames(tree):
        nonlocal state
        times, dets = [], None
        for i in range(SERVE_FRAMES):
            batch = dict(inputs, prev_exists=torch.full((1,), float(i > 0),
                                                         device=dev),
                         timestamp=torch.full((1,), 0.1 * i, device=dev))
            t0 = time.perf_counter()
            dets, state = infer(model, state, batch, tree)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for k in ('scores', 'boxes'):
                if not torch.isfinite(dets[k]).all():
                    raise AssertionError(f'frame {i}: non-finite {k}')
        return statistics.median(times[2:]), dets

    frames(q)                                          # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    int8_frame_ms, dets = frames(q)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    want = {qconv_cuda.NAMES['tma']: QCONV_TMA_PER_FRAME * SERVE_FRAMES,
            qconv_cuda.NAMES['mma']: (QCONV_PER_FRAME - QCONV_TMA_PER_FRAME)
            * SERVE_FRAMES,
            ese_requant_cuda.NAME: BLOCKS_PER_FRAME * SERVE_FRAMES,
            'msda_fwd': LAYERS_PER_FRAME * SERVE_FRAMES}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f'launches on the int8 path {launches}, '
                             f'expected {want}')
    bf16_frame_ms, _ = frames(None)
    int8_again_ms, _ = frames(q)
    log(f'  {SERVE_FRAMES} streaming frames through quant_backbone: launches '
        f'{launches} ({QCONV_TMA_PER_FRAME} qconv_tma, '
        f'{QCONV_PER_FRAME - QCONV_TMA_PER_FRAME} qconv_mma, '
        f'{BLOCKS_PER_FRAME} ese_requant and {LAYERS_PER_FRAME} msda_fwd a '
        f'frame); top score {dets["scores"][0, 0].item():.4f}, valid '
        f'{int(dets["valid"].sum())}')
    log(f'  ms/frame (median of frames 2..{SERVE_FRAMES - 1}), in turn: int8 '
        f'{int8_frame_ms:.2f}, bf16 {bf16_frame_ms:.2f}, int8 '
        f'{int8_again_ms:.2f} [{card}]')

    x_bf16 = torch.from_numpy(inference_inputs(cfg, seed=3)['images']).to(
        dev, torch.bfloat16)
    x_bf16 = x_bf16.reshape(-1, *x_bf16.shape[2:])          # held out
    x_q = quant.quantize_input(x_bf16, q['s0'])
    x_nchw = x_bf16.permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = quant.quant_vovnet_forward(cfg.backbone, q, x_q)
        ref = model.img_backbone(x_nchw)
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(got, ref)]
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError('int8 stage outputs not finite')
        log('  stage outputs, relative L2 error against the bf16 backbone on '
            'a held-out frame: ' + ', '.join(
                f'stage {i + 2} {r:.4f}' for i, r in enumerate(rel))
            + f' (tests/test_quant.py bound at the tiny size: {QUANT_REL_L2})')

        names = qconv_site_names(cfg.backbone)
        sites, tails = record_sites(
            lambda: quant.quant_vovnet_forward(cfg.backbone, q, x_q))
        if len(sites) != len(names):
            raise AssertionError(f'{len(sites)} conv sites, {len(names)} '
                                 'names')
        routes = qconv_sites_check(sites, names)
        if routes['tma'] != QCONV_TMA_PER_FRAME:
            raise AssertionError(f'{routes} of the frame\'s conv sites, '
                                 f'expected {QCONV_TMA_PER_FRAME} on TMA')
        site_t = qconv_site_times(sites, names, card)
        tail_t = ese_tail_check_and_times(tails, q, cfg.backbone, card)
        del sites, tails
        torch.cuda.empty_cache()
        int8_bb, int8_qconv, int8_tail, int8_parts = device_busy(
            lambda: quant.quant_vovnet_forward(cfg.backbone, q, x_q))
        bf16_bb, _, _, bf16_parts = device_busy(
            lambda: model.img_backbone(x_nchw))
    log(f'  backbone device busy ms (torch.profiler, mean of 3): int8 '
        f'{int8_bb:.4f} (of it qconv {int8_qconv:.4f}, ese_requant '
        f'{int8_tail:.4f}, the rest {int8_bb - int8_qconv - int8_tail:.4f}), '
        f'bf16 cuDNN {bf16_bb:.4f} [{card}]')
    log('  int8 backbone, top kernels: ' + '; '.join(
        f'{name[:60]} {ms:.4f}' for name, ms in int8_parts[:6]))
    log('  bf16 backbone, top kernels: ' + '; '.join(
        f'{name[:60]} {ms:.4f}' for name, ms in bf16_parts[:6]))
    return dict(launches={k: launches[k] for k in
                          ('qconv_tma', 'qconv_mma', 'ese_requant')},
                site_routes=routes, int8_frame_ms=int8_frame_ms,
                int8_again_ms=int8_again_ms, bf16_frame_ms=bf16_frame_ms,
                rel_l2=rel, int8_backbone_ms=int8_bb,
                int8_qconv_ms=int8_qconv, int8_tail_ms=int8_tail,
                bf16_backbone_ms=bf16_bb, tail=tail_t, **site_t)


def write_drivable_maps(workdir):
    """One drivable-area map a scene of phase 16's dataset, beside it
    ({scene}/map/log_map_archive_{scene}.json): a 100 x 50 m area around the
    ego's path, so that the ROI (5 m past it) keeps the GT boxes ahead and
    to the left of the ego and drops those well behind or to its right."""
    for scene in sorted({i['scene_id'] for i in AV2SequenceDataset(
            str(workdir / 'infos.pkl'), str(workdir)).infos}):
        mdir = workdir / scene / 'map'
        mdir.mkdir(parents=True, exist_ok=True)
        area = [(-20.0, -12.0), (80.0, -12.0), (80.0, 38.0), (-20.0, 38.0)]
        (mdir / f'log_map_archive_{scene}.json').write_text(json.dumps(
            {'drivable_areas': {'0': {'id': 0, 'area_boundary': [
                {'x': x, 'y': y, 'z': 0.0} for x, y in area]}}}))


def serving_cli(workdir, card):
    """Phase 17h: phase 16's eval again, through cli.test --quant
    --submission on its checkpoint, with the HD-map ROI gate and without."""
    write_drivable_maps(workdir)
    base = ['--data-root', str(workdir), '--ann-file',
            str(workdir / 'infos.pkl'), '--checkpoint', str(workdir / 'work'),
            '--quant', '--quant-calib-frames', str(CALIB_FRAMES)]
    out = {}
    for tag, extra in (('roi', ['--map-root', str(workdir)]), ('range', [])):
        sub = workdir / f'submission_{tag}.feather'
        t0 = time.perf_counter()
        res = cli_test.evaluate(base + extra + [
            '--submission', str(sub), '--results-dir',
            str(workdir / f'results_{tag}')])
        wall = time.perf_counter() - t0
        rows = num_rows(str(sub))
        gts = sum(v['num_gts'] for v in res['summary'].values())
        if rows != res['submission_rows'] or not all(
                np.isfinite(v) for v in res['means'].values()):
            raise AssertionError(f'cli.test {tag}: {res}, footer rows {rows}')
        out[tag] = dict(mAP=res['means']['mAP'], CDS=res['means']['CDS'],
                        rows=rows, gts=gts, frames=res['frames'])
        log(f'  cli.test --quant --submission{" --map-root" if extra else ""}'
            f': {res["frames"]} frames, mAP {res["means"]["mAP"]:.4f}, CDS '
            f'{res["means"]["CDS"]:.4f}, {gts} GT boxes evaluated, submission '
            f'{rows} rows (read back from the file\'s footer); {wall:.1f} s '
            f'[{card}]')
    if out['roi']['gts'] >= out['range']['gts']:
        raise AssertionError(f'the ROI gate dropped no GT box: {out}')
    return out


def petr_frames(step, state0, tree, dev, cfg):
    """PETR_FRAMES streaming frames from a fresh state through `step`
    (quant_tree=`tree`): ms a frame on the host clock ending in
    torch.cuda.synchronize(), the last detections."""
    state, times, dets = state0, [], None
    for i in range(PETR_FRAMES):
        t0 = time.perf_counter()
        dets, state = step(state, quant_tree=tree,
                           prev_exists=torch.full((1,), float(i > 0),
                                                  device=dev),
                           timestamp=torch.full((1,), 0.5 * i, device=dev))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for k in ('scores', 'boxes'):
            if not torch.isfinite(dets[k]).all():
                raise AssertionError(f'StreamPETR frame {i}: non-finite {k}')
        if dets['boxes'].shape != (1, cfg.max_decode_num, 9):
            raise AssertionError(f'frame {i}: boxes '
                                 f'{tuple(dets["boxes"].shape)}')
    return times, dets


def petr_cross_attention(ca, args, card):
    """Phase 18c: one decoder layer's cross attention on its operands (772
    queries x 6,000 keys, 8 heads of 32, bf16): the port's
    scaled_dot_product_attention against the JAX package's form (bf16
    einsum, scale, f32 softmax, bf16 einsum; a yardstick, never called by
    the port), their max difference, device ms and the bound."""
    q, k, v = args[:3]
    h = ca.num_heads
    d = q.shape[-1] // h

    def heads(x, proj):
        return proj(x).reshape(x.shape[0], x.shape[1], h, d).transpose(1, 2)

    qh, kh, vh = heads(q, ca.q_proj), heads(k, ca.k_proj), heads(v, ca.v_proj)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)

    def einsum_form():
        s = (qh @ kh.transpose(-1, -2)) * d ** -0.5
        return torch.softmax(s.float(), dim=-1).to(qh.dtype) @ vh

    got, want = sdpa(), einsum_form()
    diff = (got.float() - want.float()).abs().max().item()
    nbytes = (qh.numel() + kh.numel() + vh.numel() + got.numel()) * 2
    flops = 4 * qh.shape[2] * kh.shape[2] * h * d * qh.shape[0]
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    t = dict(sdpa_ms=device_ms(sdpa, 50), einsum_ms=device_ms(einsum_form, 20),
             module_ms=device_ms(lambda: ca(q, k, v), 50), max_abs_err=diff,
             bound_ms=b_ms, bound_by=b_by, out_max=want.float().abs().max()
             .item())
    if not (np.isfinite(diff) and diff <= 2e-2 * max(t['out_max'], 1.0)):
        raise AssertionError(f'cross attention: SDPA and the einsum form '
                             f'differ by {diff}')
    log(f'  cross attention of decoder layer 0, q {tuple(qh.shape)} k '
        f'{tuple(kh.shape)} {qh.dtype}: scaled_dot_product_attention '
        f'{t["sdpa_ms"]:.4f} ms, the einsum + f32 softmax form '
        f'{t["einsum_ms"]:.4f} ms, max difference {diff:.3e} (output max '
        f'{t["out_max"]:.3e}); the whole FlashMHA (projections + SDPA) '
        f'{t["module_ms"]:.4f} ms; bound {b_ms:.4f} ms ({b_by}) [{card}]')
    return t


def petr_serving_path(dev, card):
    """Phase 18a-c: StreamPETRConfig() at full width, bf16 then int8."""
    cfg = StreamPETRConfig()
    t0 = time.perf_counter()
    step, (state0,) = petr_entry(cfg)
    model = step.model
    calib = [torch.from_numpy(petr_inference_inputs(cfg, seed=s)['images'])
             .to(dev, torch.bfloat16) for s in range(1, 1 + CALIB_FRAMES)]
    q = quant.quantize_petr_backbone(model, calib)
    torch.cuda.synchronize()
    log(f'  StreamPETRConfig() built with seeded weights, its backbone '
        f'calibrated on {CALIB_FRAMES} frames and quantized in '
        f'{time.perf_counter() - t0:.1f} s: {cfg.num_cams} cameras at '
        f'{cfg.input_hw[0]}x{cfg.input_hw[1]}, {cfg.num_query} + '
        f'{cfg.num_propagated} queries, {cfg.memory_len} memory slots, '
        f'{cfg.num_layers} layers')
    ca = model.pts_bbox_head.decoder.layer0.cross_attn
    captured = {}

    def capture(module, args):
        if 'args' not in captured:
            captured['args'] = [a.detach().clone() for a in args[:3]]

    hook = ca.register_forward_pre_hook(capture)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    bf16_times, bf16_dets = petr_frames(step, state0, None, dev, cfg)
    bf16_launches = {k: v for k, v in _build.launch_counts.items() if v}
    hook.remove()
    _build.reset_launch_counts()
    int8_times, int8_dets = petr_frames(step, state0, q, dev, cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    want = {qconv_cuda.NAMES['tma']: QCONV_TMA_PER_FRAME * PETR_FRAMES,
            qconv_cuda.NAMES['mma']: (QCONV_PER_FRAME - QCONV_TMA_PER_FRAME)
            * PETR_FRAMES,
            ese_requant_cuda.NAME: BLOCKS_PER_FRAME * PETR_FRAMES}
    if bf16_launches or launches != want:
        raise AssertionError(f'StreamPETR launches: bf16 {bf16_launches} '
                             f'(none expected), int8 {launches}, expected '
                             f'{want}')
    bf16_ms = statistics.median(bf16_times[2:])
    int8_ms = statistics.median(int8_times[2:])
    log(f'  {PETR_FRAMES} streaming frames bf16, then the same {PETR_FRAMES} '
        f'through quant_backbone: launches bf16 none, int8 {launches} '
        f'({QCONV_TMA_PER_FRAME} qconv_tma, '
        f'{QCONV_PER_FRAME - QCONV_TMA_PER_FRAME} qconv_mma, '
        f'{BLOCKS_PER_FRAME} ese_requant a frame); top score bf16 '
        f'{bf16_dets["scores"][0, 0].item():.4f}, int8 '
        f'{int8_dets["scores"][0, 0].item():.4f}')
    log(f'  ms/frame (median of frames 2..{PETR_FRAMES - 1}): bf16 '
        f'{bf16_ms:.2f} (first {bf16_times[0]:.1f}), int8 {int8_ms:.2f} '
        f'(first {int8_times[0]:.1f}); peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]')

    x_bf16 = torch.from_numpy(petr_inference_inputs(cfg, seed=3)['images']
                              ).to(dev, torch.bfloat16)
    x_bf16 = x_bf16.reshape(-1, *x_bf16.shape[2:])          # held out
    x_q = quant.quantize_input(x_bf16, q['s0'])
    x_nchw = x_bf16.permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = quant.quant_vovnet_forward(cfg.backbone, q, x_q)
        ref = model.img_backbone(x_nchw)
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError('StreamPETR int8 stage outputs not finite')
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(got, ref)]
        log('  stage outputs ' + ', '.join(
            f'{tuple(a.shape[2:])}' for a in got) + ', relative L2 error '
            'against the bf16 backbone on a held-out frame: ' + ', '.join(
                f'stage {i + 2} {r:.4f}' for i, r in enumerate(rel)))

        log('== phase 18b: qconv on all 99 StreamPETR conv sites and '
            'ese_requant on its 16 block tails, as the model passes them')
        names = qconv_site_names(cfg.backbone)
        sites, tails = record_sites(
            lambda: quant.quant_vovnet_forward(cfg.backbone, q, x_q))
        if len(sites) != len(names):
            raise AssertionError(f'{len(sites)} conv sites, {len(names)} '
                                 'names')
        routes = qconv_sites_check(sites, names)
        off_tma = [(n, tuple(x.shape), qconv_cuda.pitch_of(x, 'x'))
                   for n, (x, w, *_) in zip(names, sites)
                   if x.shape[3] % 16 or qconv_cuda.pitch_of(x, 'x') % 16
                   or w.shape[0] % 16]
        log(f'  sites whose operands the TMA kernel does not take (input '
            f'shape, row pitch; it needs 16-byte aligned int8 rows): '
            f'{off_tma}')
        if routes['tma'] != QCONV_TMA_PER_FRAME:
            raise AssertionError(f'{routes} of the StreamPETR conv sites, '
                                 f'expected {QCONV_TMA_PER_FRAME} on TMA')
        site_t = qconv_site_times(sites, names, card)
        tail_t = ese_tail_check_and_times(tails, q, cfg.backbone, card)
        del sites, tails
        torch.cuda.empty_cache()
        int8_bb, int8_qconv, int8_tail, int8_parts = device_busy(
            lambda: quant.quant_vovnet_forward(cfg.backbone, q, x_q))
        bf16_bb, _, _, bf16_parts = device_busy(
            lambda: model.img_backbone(x_nchw))
        log(f'  StreamPETR backbone device busy ms (torch.profiler, mean of '
            f'3): int8 {int8_bb:.4f} (of it qconv {int8_qconv:.4f}, '
            f'ese_requant {int8_tail:.4f}), bf16 cuDNN {bf16_bb:.4f} [{card}]')
        frame_busy, _, _, frame_parts = device_busy(
            lambda: step(state0, quant_tree=None), reps=3)
        log(f'  a whole bf16 StreamPETR frame, device busy {frame_busy:.4f} '
            'ms; top kernels: ' + '; '.join(
                f'{name[:60]} {ms:.4f}' for name, ms in frame_parts[:5]))

        log('== phase 18c: the cross attention of one decoder layer')
        attn = petr_cross_attention(ca, captured['args'], card)
    return dict(launches=launches, bf16_launches=bf16_launches,
                site_routes=routes, off_tma=off_tma,
                bf16_frame_ms=bf16_ms, int8_frame_ms=int8_ms, rel_l2=rel,
                int8_backbone_ms=int8_bb, int8_qconv_ms=int8_qconv,
                int8_tail_ms=int8_tail, bf16_backbone_ms=bf16_bb,
                bf16_frame_busy_ms=frame_busy, tail=tail_t, attn=attn,
                **site_t)


def petr_train_path(card):
    """Phase 18d: PETR_STEPS full-width StreamPETR training steps through
    petr_train_entry (grid mask, dropout, bf16 images)."""
    step, (ts, tt) = petr_train_entry()
    model = ts.model
    pseudo = model.pts_bbox_head.pseudo_reference_points
    pseudo0 = pseudo.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], None
    _build.reset_launch_counts()
    for i in range(PETR_STEPS):
        t0 = time.perf_counter()
        ts, tt, metrics = step(ts, tt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f'StreamPETR step {i}: non-finite {bad}')
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    if launches:
        raise AssertionError(f'StreamPETR training launched {launches}; its '
                             'step runs no port kernel (bf16 backbone, no '
                             'deformable attention)')
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = moved = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if p.grad is not None and bool(p.grad.abs().max() > 0):
            grads += 1
            mom = ts.optimizer.state[p]['exp_avg']
            if not bool(mom.abs().max() > 0):
                raise AssertionError(f'{name}: a gradient, but Adam\'s moment '
                                     'did not move')
            moved += 1
    if pseudo.requires_grad or not torch.equal(pseudo.detach(), pseudo0):
        raise AssertionError('pseudo_reference_points moved')
    ms = statistics.median(times[2:PETR_STEPS])
    n_params = sum(1 for _ in model.parameters())
    log(f'  {PETR_STEPS} steps: ms/step (median of steps 2..'
        f'{PETR_STEPS - 1}) {ms:.2f}, first {times[0]:.1f}; peak memory '
        f'{peak:.2f} GiB; last total_loss '
        f'{float(metrics["total_loss"]):.4f}, grad_norm '
        f'{float(metrics["grad_norm"]):.4f}; Adam moments moved for all '
        f'{moved} of {n_params} parameters with a gradient (the rest: the '
        'frozen pseudo reference points and the FPN convs of levels it does '
        'not read); pseudo_reference_points unchanged; no port kernel '
        f'launched [{card}]')
    return dict(ms_step=ms, peak_gib=peak, launches=launches, moved=moved,
                total_loss=float(metrics['total_loss']),
                grad_norm=float(metrics['grad_norm']))


def petr_dataset_path(workdir, card):
    """Phase 18e: a learnable nuScenes dataset of 2 scenes x 4 frames, 2
    cameras of PNG at the model's 320x800, through cli.train_nusc
    (PETR_DATA_STEPS steps, full StreamPETRConfig() width) and cli.test_nusc
    on its checkpoint, bf16 and --quant."""
    t0 = time.perf_counter()
    make_learnable_nusc_dataset(str(workdir / 'infos.pkl'), str(workdir),
                                n_scenes=2, frames_per_scene=4,
                                src_hw=PETR_DATA_HW)
    log(f'  dataset written in {time.perf_counter() - t0:.1f} s')
    base = ['--data-root', str(workdir), '--ann-file',
            str(workdir / 'infos.pkl'), '--src-wh', str(PETR_DATA_HW[1]),
            str(PETR_DATA_HW[0]), '--set', 'num_cams=2']
    work = workdir / 'work'
    t0 = time.perf_counter()
    cli_train_nusc.main(base + [
        '--work-dir', str(work), '--max-iters', str(PETR_DATA_STEPS),
        '--log-interval', '1', '--ckpt-interval', str(PETR_DATA_STEPS)])
    train_s = time.perf_counter() - t0
    lines = [json.loads(x) for x in open(work / 'metrics.jsonl')]
    if [x['iter'] for x in lines] != list(range(1, PETR_DATA_STEPS + 1)) or \
            not all(np.isfinite(x['total_loss']) for x in lines):
        raise AssertionError(f'cli.train_nusc metrics: {lines}')
    log(f'  cli.train_nusc: {PETR_DATA_STEPS} steps in {train_s:.1f} s, '
        'losses ' + ', '.join(f'{x["total_loss"]:.3f}' for x in lines)
        + ', s/step ' + ', '.join(f'{x["time"]:.3f}' for x in lines)
        + f' [{card}]')
    out = {}
    for tag, extra in (('bf16', []),
                       ('int8', ['--quant', '--quant-calib-frames',
                                 str(CALIB_FRAMES)])):
        t0 = time.perf_counter()
        res = cli_test_nusc.evaluate(base + ['--checkpoint', str(work)]
                                     + extra)
        wall = time.perf_counter() - t0
        m = res['means']
        if res['frames'] != 8 or not (np.isfinite(m['mAP'])
                                      and np.isfinite(m['NDS'])):
            raise AssertionError(f'cli.test_nusc {tag}: {res}')
        out[tag] = dict(mAP=m['mAP'], NDS=m['NDS'], frames=res['frames'],
                        wall_s=wall)
        log(f'  cli.test_nusc {" ".join(extra[:1])}: {res["frames"]} frames, '
            f'mAP {m["mAP"]:.4f}, NDS {m["NDS"]:.4f}, {wall:.1f} s [{card}]')
    return dict(train_s=train_s, eval=out)


# ---------------------------------------------------------------- phase 19
# Data parallelism and camera sharding (far3d_tpu_torch/parallel/). Each
# rank is a process of this script started with --rank-worker; it prints one
# RESULT line of JSON that its parent reads.

MSDA_NAMES = (msda_cuda.FWD, msda_cuda.DVAL, msda_cuda.DATTN)


class RepeatBatch:
    """A loader that hands out one batch of CPU tensors forever."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return itertools.repeat(self.batch)


def param_digest(model):
    """sha256 of every parameter's and buffer's bytes, in state-dict order."""
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def worker_nccl1(work):
    """19a: run_training at full width for NCCL_STEPS steps without a group,
    then the same under an NCCL group of one (torchrun's variables)."""
    cfg = Far3DConfig()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every=1))
    loader = RepeatBatch(synthetic_batch(cfg, 1, 0))
    runner.run_training(cfg, loader, str(work / 'nogroup'), 1, resume=False,
                        max_iters=NCCL_STEPS, device='cuda')
    torch.cuda.empty_cache()
    rank, world = mesh.init_distributed()
    backend = torch.distributed.get_backend()
    sent = []
    real = mesh.all_reduce_mean_

    def counting(tensors, *args, **kw):
        sent.append(real(tensors, *args, **kw))
        return sent[-1]

    mesh.all_reduce_mean_ = counting
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runner.run_training(cfg, loader, str(work / 'nccl'), 1, resume=False,
                        max_iters=NCCL_STEPS, device='cuda')
    launches = {k: _build.launch_counts[k] for k in MSDA_NAMES}
    mesh.all_reduce_mean_ = real
    mesh.shutdown()
    return dict(backend=backend, rank=rank, world=world, bytes_per_step=sent,
                launches=launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                nogroup=read_metrics(work / 'nogroup' / 'metrics.jsonl'),
                group=read_metrics(work / 'nccl' / 'metrics.jsonl'))


def worker_full(work):
    """19b: DP_STEPS full-width Far3D steps on this rank's lane of a batch
    of two, from rank 0's weights; per step the ms, the time spent in
    all-reduces (each synchronized on both sides), the losses and a digest
    of the parameters and buffers."""
    rank, world = mesh.rank_and_world()
    cfg = Far3DConfig()
    model = build_model(cfg, 'cuda', 0)
    state, tstate = create_train_state(cfg, model, batch=1)
    mesh.broadcast_module_(model)
    batch = {k: v.cuda() for k, v in mesh.shard_batch(
        synthetic_batch(cfg, world, 0), rank, world).items()}
    noise_gen = torch.Generator()
    dropout_gen = torch.Generator(device='cuda')
    comm = [0.0]
    real = torch.distributed.all_reduce

    def timed(t, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *args, **kw)
        torch.cuda.synchronize()
        comm[0] += time.perf_counter() - t0
        return out

    torch.distributed.all_reduce = timed
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    steps = []
    for i in range(DP_STEPS):
        noise_gen.manual_seed(runner.step_seed(0, i))
        dropout_gen.manual_seed(runner.step_seed(0, i, rank))
        comm[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, tstate, m = train_step(cfg, state, tstate, batch, noise_gen,
                                      dropout_gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append(dict(ms=ms, comm_ms=comm[0] * 1e3,
                          losses={k: float(v) for k, v in m.items()},
                          digest=param_digest(model)))
    torch.distributed.all_reduce = real
    return dict(rank=rank, steps=steps,
                launches={k: _build.launch_counts[k] for k in MSDA_NAMES},
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def tiny_inputs(family):
    """19c's tiny f32 runs without dropout: config, weights, a batch of two
    and two steps' global draws from one CPU generator."""
    gen = torch.Generator().manual_seed(0)
    if family == 'far3d':
        cfg = no_dropout_f32(tiny_test_config())
        return dict(cfg=cfg, weights=random_reference_state_dict(cfg, 0),
                    batch=synthetic_batch(cfg, 2, 6),
                    noises=[draw_step_noise(cfg, 2, gen) for _ in range(2)])
    cfg = dataclasses.replace(tiny_petr_config(), dropout=0.0)
    tcfg = dataclasses.replace(TrainConfig(), lr=2e-3, warmup_iters=1,
                               dtype='float32', ema_decay=0.0)
    return dict(cfg=cfg, train_cfg=tcfg,
                weights=petr_init_state_dict(cfg, 0),
                batch=petr_synthetic_batch(cfg, 2, 6),
                noises=[draw_petr_noise(cfg, tcfg, gen) for _ in range(2)])


def run_tiny(family, inp, device, rank=0, world=1):
    """Two steps of `inp` on this rank's lanes -> (metrics, state dict,
    Adam first moments, parameters before), on the CPU."""
    cfg = inp['cfg']
    lanes = inp['batch']['images'].shape[0] // world
    if family == 'far3d':
        state, tstate = create_train_state(
            cfg, build_model(cfg, device, weights=inp['weights']), lanes)

        def step(state, tstate, batch, noise):
            return step_from_noise(cfg, state, tstate, batch, noise)
    else:
        tcfg = inp['train_cfg']
        state, tstate = create_petr_train_state(
            build_petr_model(cfg, device, weights=inp['weights']), tcfg,
            lanes)

        def step(state, tstate, batch, noise):
            return petr_step_from_noise(cfg, tcfg, state, tstate, batch,
                                        noise)
    before = {k: p.detach().cpu().clone()
              for k, p in state.model.named_parameters()}
    batch = {k: v.to(device) for k, v in
             mesh.shard_batch(inp['batch'], rank, world).items()}
    metrics = []
    for i, noise in enumerate(inp['noises']):
        if i:
            batch['prev_exists'] = torch.ones_like(batch['prev_exists'])
        state, tstate, m = step(state, tstate, batch,
                                mesh.shard_batch(noise, rank, world))
        metrics.append({k: float(v) for k, v in m.items()})
    moments = {k: state.optimizer.state.get(p, {}).get(
        'exp_avg', torch.zeros_like(p)).cpu()
        for k, p in state.model.named_parameters()}
    return (metrics, {k: v.cpu() for k, v in state.model.state_dict().items()},
            moments, before)


def worker_tiny(work, family):
    rank, world = mesh.rank_and_world()
    inp = torch.load(work / f'tiny_{family}.pt', weights_only=False)
    torch.save(run_tiny(family, inp, 'cuda', rank, world),
               work / f'tiny_{family}_{rank}.pt')
    return dict(rank=rank)


def worker_cli_test(work, argv):
    """19d: one rank of cli.test on this card; the rank joins its group
    over gloo first (FAR3D_*), which cli.test then keeps, since NCCL
    refuses two ranks on one card."""
    mesh.init_distributed(backend='gloo')
    res = cli_test.evaluate(argv)
    rank = mesh.rank_and_world()[0]
    mesh.shutdown()
    return dict(rank=rank, frames=res['frames'], means=res['means'])


def rank_worker(mode, work, *args):
    """A phase-19 process (see spawn_ranks)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    if mode == 'nccl1':
        out = worker_nccl1(work)
    elif mode == 'cli_test':
        out = worker_cli_test(work, list(args))
    else:
        mesh.init_distributed(backend='gloo')
        try:
            out = worker_full(work) if mode == 'full' else \
                worker_tiny(work, *args)
        finally:
            mesh.shutdown()
    print('RESULT ' + json.dumps(out), flush=True)
    return 0


def spawn_ranks(mode, work, envs, args=()):
    """One process of this script's --rank-worker `mode` per entry of `envs`
    (its extra environment), each logging to `work`/<mode>_<r>.log; a rank
    that fails, or RANK_TIMEOUT_S, kills the others. Returns each rank's
    RESULT object."""
    base = {k: v for k, v in os.environ.items()
            if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                         'MASTER_PORT', 'FAR3D_COORDINATOR')}
    logs = [work / f'{mode}_{r}.log' for r in range(len(envs))]
    procs = []
    for log_path, env in zip(logs, envs):
        with open(log_path, 'w') as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 '--rank-worker', mode, str(work), *args],
                env={**base, **env}, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for r, (p, log_path) in enumerate(zip(procs, logs)):
        text = log_path.read_text()
        lines = [ln for ln in text.splitlines() if ln.startswith('RESULT ')]
        if p.returncode != 0 or not lines:
            raise AssertionError(f'{mode} rank {r} exited {p.returncode}:\n'
                                 f'{text[-6000:]}')
        results.append(json.loads(lines[-1][len('RESULT '):]))
    return results


def gloo_envs(store, world=2):
    """`world` ranks meeting at the file store `store` (a new path)."""
    return [dict(FAR3D_COORDINATOR=f'file://{store}',
                 FAR3D_NUM_PROCESSES=str(world), FAR3D_PROCESS_ID=str(r))
            for r in range(world)]


def dp_nccl_world1(work, card, ms_step9):
    """19a."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    res, = spawn_ranks('nccl1', work, [dict(
        RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
        MASTER_PORT=str(port))])
    wall = time.perf_counter() - t0
    if res['backend'] != 'nccl' or res['world'] != 1:
        raise AssertionError(f'19a: {res["backend"]}, world {res["world"]}')
    want = {k: LAYERS_PER_FRAME * NCCL_STEPS for k in MSDA_NAMES}
    if res['launches'] != want:
        raise AssertionError(f'19a: launches {res["launches"]}, want {want}')
    keys = [k for k in res['group'][0] if k not in ('iter', 'time',
                                                    'data_time')]
    equal, diffs = [], []
    for s, (a, b) in enumerate(zip(res['nogroup'], res['group'])):
        bad = [k for k in keys if not np.isfinite(b[k])]
        if bad:
            raise AssertionError(f'19a step {s}: non-finite {bad}')
        diff = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for k in keys)
        equal.append(all(a[k] == b[k] for k in keys))
        diffs.append(diff)
        log(f'  step {s}: total_loss {b["total_loss"]:.6f} (without a group '
            f'{a["total_loss"]:.6f}), grad_norm {b["grad_norm"]:.4f}; all '
            f'{len(keys)} metrics bitwise equal to the run without a group: '
            f'{equal[-1]} (largest relative difference {diff:.3e}); '
            f'{b["time"] * 1e3:.1f} ms/step [{card}]')
    if not equal[0]:
        raise AssertionError('19a: the first step (the same weights and '
                             'inputs) differs from the run without a group')
    if max(diffs) > 1e-3:
        raise AssertionError(f'19a: metrics apart by {max(diffs):.3e}')
    ms = [m['time'] * 1e3 for m in res['group']]
    log(f'  backend {res["backend"]}, world size {res["world"]}; gradients '
        f'all-reduced a step: {res["bytes_per_step"][0] / 2**20:.1f} MiB '
        f'(f32, {len(res["bytes_per_step"])} steps); launches {res["launches"]}'
        f'; ms/step {ms[-1]:.1f} (step {NCCL_STEPS - 1} of run_training; '
        f'step 1 carries the first save) beside phase 9\'s {ms_step9:.2f}; '
        f'peak '
        f'{res["peak_gib"]:.2f} GiB; {wall:.1f} s with the process start '
        f'[{card}]')
    return dict(launches=res['launches'], ms_step=ms[-1],
                bytes_per_step=res['bytes_per_step'][0],
                bitwise_steps=equal, max_rel_diff=diffs)


def dp_gloo_full(work, card):
    """19b."""
    t0 = time.perf_counter()
    ranks = spawn_ranks('full', work, gloo_envs(work / 'store_full'))
    wall = time.perf_counter() - t0
    for s in range(DP_STEPS):
        a, b = (r['steps'][s] for r in ranks)
        if a['digest'] != b['digest']:
            raise AssertionError(f'19b step {s}: the ranks\' parameters '
                                 'differ')
        for r, st in enumerate((a, b)):
            bad = [k for k, v in st['losses'].items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f'19b step {s} rank {r}: non-finite '
                                     f'{bad}')
        if a['losses'] != b['losses']:
            raise AssertionError(f'19b step {s}: the ranks log other means')
        log(f'  step {s}: parameters and buffers bitwise equal on both ranks '
            f'(sha256 {a["digest"][:16]}), total_loss '
            f'{a["losses"]["total_loss"]:.4f} (mean of the ranks), grad_norm '
            f'{a["losses"]["grad_norm"]:.3f}')
    want = {k: LAYERS_PER_FRAME * DP_STEPS for k in MSDA_NAMES}
    out = []
    for r, res in enumerate(ranks):
        if res['launches'] != want:
            raise AssertionError(f'19b rank {r}: launches {res["launches"]}, '
                                 f'want {want}')
        ms = [st['ms'] for st in res['steps']]
        comm = [st['comm_ms'] for st in res['steps']]
        log(f'  rank {r} (two ranks sharing one card, not a scaling number): '
            f'ms/step {", ".join(f"{v:.1f}" for v in ms)}; all-reduces '
            f'{", ".join(f"{v:.1f}" for v in comm)} ms of them '
            f'({100 * comm[-1] / ms[-1]:.1f}% of the last step, each '
            f'all-reduce synchronized on both sides); peak '
            f'{res["peak_gib"]:.2f} GiB; launches {res["launches"]} [{card}]')
        out.append(dict(ms_steps=ms, comm_ms=comm, peak_gib=res['peak_gib'],
                        launches=res['launches']))
    log(f'  {wall:.1f} s with the process starts')
    return out


def dp_tiny(work, card):
    """19c."""
    out = {}
    for family, floor in (('far3d', 1e-12), ('petr', 1e-8)):
        inp = tiny_inputs(family)
        torch.save(inp, work / f'tiny_{family}.pt')
        spawn_ranks('tiny', work, gloo_envs(work / f'store_tiny_{family}'),
                    args=(family,))
        ranks = [torch.load(work / f'tiny_{family}_{r}.pt',
                            weights_only=False) for r in range(2)]
        for k, v in ranks[0][1].items():
            if not torch.equal(v, ranks[1][1][k]):
                raise AssertionError(f'19c {family}: {k} differs by rank')
        single = run_tiny(family, inp, 'cuda')
        moved, n = hold_run(ranks[0], single, floor)
        m = ranks[0][0]
        log(f'  tiny {family}, two gloo ranks at batch 1 against one process '
            f'at batch 2, on the card: {len(m[0])} metrics x 2 steps (tol '
            f'{TINY_TOL}), Adam first moments of {n[0]} parameters ({moved} '
            f'with a gradient), {n[1]} parameters and buffers (BN statistics '
            f'among them) agree; the ranks bitwise equal; total_loss '
            f'{m[0]["total_loss"]:.4f} -> {m[1]["total_loss"]:.4f} [{card}]')
        out[family] = dict(moved=moved, compared=n)
    return out


def dp_cli_test(work, data_dir, card):
    """19d."""
    base = ['--data-root', str(data_dir), '--ann-file',
            str(data_dir / 'infos.pkl'), '--checkpoint',
            str(data_dir / 'work')]
    two, one = work / 'results_two', work / 'results_one'
    t0 = time.perf_counter()
    ranks = spawn_ranks('cli_test', work, gloo_envs(work / 'store_test'),
                        args=base + ['--results-dir', str(two)])
    wall2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = cli_test.evaluate(base + ['--results-dir', str(one)])
    wall1 = time.perf_counter() - t0
    parts = []
    for r in range(2):
        with open(two / f'part_{r}.pkl', 'rb') as f:
            parts.extend(pickle.load(f))
    with open(one / 'part_0.pkl', 'rb') as f:
        ref = pickle.load(f)
    order, want = [p['index'] for p in parts], [p['index'] for p in ref]
    if order != want:
        raise AssertionError(f'19d: parts in order {order}, one process '
                             f'{want}')
    got = ranks[0]['means']
    if got['mAP'] != single['means']['mAP'] or \
            got['CDS'] != single['means']['CDS']:
        raise AssertionError(f'19d: two ranks {got}, one {single["means"]}')
    counts = [(len(a['scores']), len(b['scores'])) for a, b in zip(parts, ref)]
    if any(x != y for x, y in counts):
        raise AssertionError(f'19d: detections a frame {counts}')
    det = max((float(np.abs(a[k] - b[k]).max()) if len(a[k]) else 0.0)
              for a, b in zip(parts, ref) for k in ('scores', 'boxes'))
    log(f'  cli.test on two gloo ranks of this card: rank 0 scored '
        f'{ranks[0]["frames"]} frames (every rank\'s), rank 1 streamed '
        f'{ranks[1]["frames"]}; the parts in rank order hold '
        f'frames {order}, as one process; mAP {got["mAP"]:.6f}, CDS '
        f'{got["CDS"]:.6f}, equal to one process\'s; largest difference of a '
        f'score or box coordinate {det:.3e}; {wall2:.1f} s (two processes) '
        f'against {wall1:.1f} s (in this one) [{card}]')
    return dict(order=order, mAP=got['mAP'], CDS=got['CDS'], det_diff=det)


def pair_one_to_one(costs, forbid=None):
    """The one-to-one pairing of two sets of n entries that least sums the
    pairs' costs, a pair's cost the largest of `costs` (n x n matrices of
    distances, each in units of its tolerance); the pairs that `forbid`
    marks cost 1e9. Returns, for each entry of the first set, the index of
    its partner in the second."""
    cost = torch.stack(costs).amax(0)
    if forbid is not None:
        cost = cost.masked_fill(forbid, 1e9)
    rows, cols = linear_sum_assignment(cost.double().cpu().numpy())
    assert (rows == np.arange(len(rows))).all()
    return torch.as_tensor(cols, device=cost.device)


def repeats(x):
    """How many rows of `x` repeat an earlier row exactly."""
    return len(x) - len(torch.unique(x, dim=0))


def match_frames(ds, du, ss, su):
    """Two decodes and states of one frame, compared where their order may
    differ (queries and memory slots of equal or nearly equal score come out
    of a top-K in either order, and a memory slot's order is its propagated
    query's): the scores in rank order; the detections paired one to one
    (``pair_one_to_one``: box and score, a box only with one of its class)
    and the memory slots likewise (reference point and embedding), each
    with its largest difference over the pairs and the largest entry it is
    relative to. Also counts what reorders a top-K: detection scores and
    memory slots that repeat another exactly, scores within the frames'
    own score difference of the next, and the entries paired off their
    own position."""
    inf = float('inf')

    def tol(key, ref):
        rtol, atol = CAM_TOL[key]
        return atol + rtol * float(ref.abs().max())

    a_s, b_s = ds['scores'][0], du['scores'][0]
    a_l, b_l = ds['labels'][0], du['labels'][0]
    a_b, b_b = ds['boxes'][0], du['boxes'][0]
    if a_b.shape != b_b.shape or not torch.equal(
            torch.sort(a_l).values, torch.sort(b_l).values):
        raise AssertionError(f'19e: detections of other counts by class: '
                             f'{a_l.bincount().tolist()} against '
                             f'{b_l.bincount().tolist()}')
    ranked = float((torch.sort(a_s, descending=True).values
                    - torch.sort(b_s, descending=True).values).abs().max())
    det = pair_one_to_one(
        [torch.cdist(a_b, b_b, p=inf) / tol('boxes', b_b),
         (a_s[:, None] - b_s[None]).abs() / tol('scores', b_s)],
        forbid=a_l[:, None] != b_l[None])
    if not torch.equal(a_l, b_l[det]):
        raise AssertionError('19e: a detection paired with one of another '
                             'class')
    gaps = torch.sort(b_s).values.diff()
    out = dict(scores=max(ranked, float((a_s - b_s[det]).abs().max())),
               scores_max=float(b_s.abs().max()), scores_ranked=ranked,
               boxes=float((a_b - b_b[det]).abs().max()),
               boxes_max=float(b_b.abs().max()),
               tied_scores=repeats(b_s[:, None]),
               near_tied_scores=int((gaps <= ranked).sum()),
               detections=len(b_s), detections_moved=int(
                   (det != torch.arange(len(det), device=det.device)).sum()))
    a_r, b_r = ss.ref_points[0], su.ref_points[0]
    a_e, b_e = ss.embedding[0], su.embedding[0]
    slot = pair_one_to_one(
        [torch.cdist(a_r, b_r, p=inf) / tol('ref_points', b_r),
         torch.cdist(a_e, b_e, p=inf) / tol('embedding', b_e)])
    out.update(ref_points=float((a_r - b_r[slot]).abs().max()),
               ref_points_max=float(b_r.abs().max()),
               embedding=float((a_e - b_e[slot]).abs().max()),
               embedding_max=float(b_e.abs().max()),
               tied_slots=repeats(torch.cat([b_r, b_e], 1)),
               slots=len(b_r), slots_moved=int(
                   (slot != torch.arange(len(slot), device=slot.device))
                   .sum()))
    return out


def cam_shard_phase(cfg, dev, card, ms_frame4):
    """19e: the frame through seven one-camera slices on this card against
    the unsharded model. First two streamed frames with f32 images (the
    second with the carried state), compared by match_frames at CAM_TOL;
    the per-slice towers run at batch 1 instead of 7, so cuDNN may sum in
    another order. Then CAM_FRAMES frames each way
    with bf16 images, the served dtype, timed; the FPN output of the first
    held against the unsharded pass (CAM_FPN_TOL). With bf16 towers the
    decoded detections are not compared: a rounding step in a proposal
    score reorders the 2D top-K, and the queries then differ."""
    model = build_model(cfg, dev, 0)
    inputs = {k: torch.from_numpy(v).to(dev)
              for k, v in inference_inputs(cfg, batch=1, seed=0).items()}
    run = make_cam_sharded_infer(model, cfg, [dev] * cfg.data.num_cams)

    def frame_inputs(i, dtype):
        return dict(inputs, images=inputs['images'].to(dtype),
                    prev_exists=torch.full((1,), float(i > 0), device=dev),
                    timestamp=torch.full((1,), 0.1 * i, device=dev))

    sharded = unsharded = init_state(1, cfg.head, dev)
    diffs = []
    for i in range(2):
        kw = frame_inputs(i, torch.float32)
        ds, sharded = run(sharded, kw)
        du, unsharded = run_frame(model, unsharded, **kw)
        d = match_frames(ds, du, sharded, unsharded)
        diffs.append(d)
        log(f'  f32 frame {i}: sharded against unsharded, paired one to '
            f'one: scores apart by <= {d["scores"]:.3e} (in rank order and '
            f'paired), boxes by <= {d["boxes"]:.3e}, memory slots by <= '
            f'{d["ref_points"]:.3e} (reference point) and '
            f'{d["embedding"]:.3e} (embedding) (tol {CAM_TOL}); '
            f'{d["detections_moved"]} of {d["detections"]} detections and '
            f'{d["slots_moved"]} of {d["slots"]} slots paired off their '
            f'position; {d["tied_scores"]} scores and {d["tied_slots"]} '
            f'slots repeat another exactly, {d["near_tied_scores"]} scores '
            f'lie within {d["scores_ranked"]:.3e} of the next')
        bad = [k for k, (rtol, atol) in CAM_TOL.items()
               if not d[k] <= atol + rtol * d[f'{k}_max']]
        if bad:
            raise AssertionError(f'19e f32 frame {i}: {bad} {d}')

    captured = []
    hook = model.img_neck.register_forward_hook(
        lambda m, args, out: captured.append([f.float() for f in out]))
    sharded = unsharded = init_state(1, cfg.head, dev)
    ms_s, ms_u, launches = [], [], 0
    for i in range(CAM_FRAMES):
        kw = frame_inputs(i, torch.bfloat16)
        torch.cuda.synchronize()
        n0 = _build.launch_counts[msda_cuda.FWD]
        t0 = time.perf_counter()
        ds, sharded = run(sharded, kw)
        torch.cuda.synchronize()
        ms_s.append((time.perf_counter() - t0) * 1e3)
        launches += _build.launch_counts[msda_cuda.FWD] - n0
        t0 = time.perf_counter()
        du, unsharded = run_frame(model, unsharded, **kw)
        torch.cuda.synchronize()
        ms_u.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.isfinite(ds[k]).all() for k in ('scores', 'boxes')):
            raise AssertionError(f'19e bf16 frame {i}: non-finite detections')
        if i == 0:
            hook.remove()
            *slices, whole = captured
            if len(slices) != cfg.data.num_cams:
                raise AssertionError(f'19e: {len(slices)} tower passes')
            fpn = max(float((torch.cat([sl[lvl] for sl in slices])
                             - whole[lvl]).abs().max()
                            / whole[lvl].abs().max())
                      for lvl in range(len(whole)))
            del captured, slices, whole
            log(f'  bf16 frame 0: the FPN output of the seven slices apart '
                f'from the unsharded pass by <= {fpn:.3e} of its largest '
                f'entry (tol {CAM_FPN_TOL})')
            if not fpn <= CAM_FPN_TOL:
                raise AssertionError(f'19e: FPN apart by {fpn:.3e}')
    if launches != LAYERS_PER_FRAME * CAM_FRAMES:
        raise AssertionError(f'19e: msda_fwd launched {launches} times')
    sm, um = statistics.median(ms_s[2:]), statistics.median(ms_u[2:])
    log(f'  {cfg.data.num_cams} slices of one camera on this one card, bf16: '
        f'{sm:.2f} ms/frame sharded, {um:.2f} unsharded (medians of frames '
        f'2..{CAM_FRAMES - 1}), phase 4: {ms_frame4:.2f}; one card: no '
        f'latency gain measurable; msda_fwd launched {launches} times '
        f'({LAYERS_PER_FRAME} a sharded frame) [{card}]')
    return dict(ms_sharded=sm, ms_unsharded=um, launches=launches,
                f32_diffs=diffs, bf16_fpn_diff=fpn)


# ---------------------------------------------------------------- phase 20
def scipy_hungarian_match(costs, col_valid):
    """The port's matching before the auction, the phase-20 baseline: the
    costs to the host in one copy (invalid columns at BIG_COST), scipy's
    exact solver per problem (lsa_host), the rows back in one copy."""
    masked = [torch.where(v[..., None, :], c.detach().float(),
                          torch.full_like(c, matching.BIG_COST,
                                          dtype=torch.float32))
              for c, v in zip(costs, col_valid)]
    host = torch.cat([m.reshape(-1) for m in masked]).cpu().numpy()
    rows, off = [], 0
    for m in masked:
        rows.append(matching.lsa_host(host[off:off + m.numel()].reshape(
            m.shape)))
        off += m.numel()
    flat = torch.from_numpy(np.concatenate([r.reshape(-1) for r in rows]))
    flat = flat.to(costs[0].device)
    out, off = [], 0
    for r in rows:
        out.append(flat[off:off + r.size].reshape(r.shape))
        off += r.size
    return out


class Matcher:
    """Within the block, every matching of the training step goes through
    `fn` (losses3d and dn look hungarian_match up at call time); `record`
    keeps clones of the (costs, col_valid) of each call."""

    def __init__(self, fn=None, record=None):
        self.fn, self.record = fn, record

    def __enter__(self):
        self.saved = losses3d.hungarian_match, dn_mod.hungarian_match
        inner = self.fn or self.saved[0]

        def call(costs, col_valid):
            if self.record is not None:
                self.record.append(([c.detach().clone() for c in costs],
                                    [v.clone() for v in col_valid]))
            return inner(costs, col_valid)
        losses3d.hungarian_match = dn_mod.hungarian_match = call

    def __exit__(self, *exc):
        losses3d.hungarian_match, dn_mod.hungarian_match = self.saved


def timed_ms(fn, reps):
    """Host wall ms of fn() (synchronized), median of `reps` after one."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def auction_eager_solver(benefit, valid, eps):
    """The auction on a padded problem batch with its CHECK_EVERY-iteration
    chunks launched op by op (matching._iterate), for the timing against
    the module's CUDA-graph replay; returns solve() -> rows."""
    def solve():
        nb, c, r = benefit.shape
        dev = benefit.device
        price = torch.zeros(nb, r, device=dev)
        owner = torch.full((nb, r), -1, dtype=torch.long, device=dev)
        assign = torch.where(valid, -1, -2).long()
        iters = torch.zeros((), dtype=torch.long, device=dev)
        done = 0
        while done < 500 and bool((assign == -1).any()):
            n = min(matching.CHECK_EVERY, 500 - done)
            matching._iterate(benefit, valid, eps, price, owner, assign,
                              iters, n)
            done += n
        if bool((assign == -1).any()):
            matching._greedy(benefit, owner, assign)
        return assign.clamp_min(0)
    return solve


def matching_gaps(costs, col_valid, rows):
    """Per problem: the auction's total cost over the valid columns against
    scipy's optimum -> (relative gaps, all assignments distinct)."""
    gaps, distinct = [], True
    for cost, valid, got in zip(costs, col_valid, rows):
        r, c = cost.shape[-2:]
        cost = cost.detach().float().reshape(-1, r, c).cpu()
        valid = valid.reshape(-1, c).cpu()
        got = got.reshape(-1, c).cpu()
        opt = torch.from_numpy(matching.lsa_host(torch.where(
            valid[:, None], cost, matching.BIG_COST).numpy()))
        for i in range(cost.shape[0]):
            cols = valid[i].nonzero()[:, 0]
            if not len(cols):
                continue
            ours = cost[i, got[i, cols], cols].double().sum().item()
            best = cost[i, opt[i, cols], cols].double().sum().item()
            gaps.append((ours - best) / max(abs(best), 1e-6))
            distinct &= len(set(got[i, cols].tolist())) == len(cols)
    return gaps, distinct


def matching_family(name, make, card, steps=MATCH_STEPS):
    """Phase 20a for one family: `make()` -> (step, (train_state, tstate))
    at full width. Captures one step's matching problems; times scipy
    (lsa_host, the port's matching before) and the auction on them, the
    auction's iterations, the auction on the card against the CPU
    bitwise and against scipy's optimum; then ms/step with each matcher,
    alternating, in this call."""
    step, (ts, tt) = make()
    t0 = time.perf_counter()
    ts, tt, _ = step(ts, tt)                   # warm-up, the graph's capture
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    captured = []
    with Matcher(record=captured):
        ts, tt, _ = step(ts, tt)
    torch.cuda.synchronize()
    costs, valid = captured[0]
    shapes = [tuple(c.shape) for c in costs]
    n_gt = int(valid[0].sum())
    scipy_ms = timed_ms(lambda: scipy_hungarian_match(costs, valid), 5)
    auction_ms = timed_ms(lambda: matching.hungarian_match(costs, valid), 5)
    matching.reset_stats()
    rows = matching.hungarian_match(costs, valid)
    stats = dict(matching.STATS)
    cpu_rows = matching.hungarian_match([c.cpu() for c in costs],
                                        [v.cpu() for v in valid])
    bitwise = all(torch.equal(a.cpu(), b) for a, b in zip(rows, cpu_rows))
    if not bitwise:
        raise AssertionError(f'{name}: the auction on the card differs from '
                             'the auction on the CPU on the same costs')
    gaps, distinct = matching_gaps(costs, valid, rows)
    if not distinct:
        raise AssertionError(f'{name}: the auction gave a row to two columns')
    if max(gaps) > MATCH_GAP:
        raise AssertionError(f'{name}: the auction\'s cost is {max(gaps):.4%} '
                             f'over scipy\'s optimum, above {MATCH_GAP:.1%}')
    benefit, pvalid, eps = matching.padded_problems(costs, valid)
    solve = auction_eager_solver(benefit, pvalid, eps)
    if not torch.equal(solve(), matching._solve(benefit, pvalid, eps, 500)):
        raise AssertionError(f'{name}: the eager chunks differ from the '
                             'graph replay')
    eager_ms = timed_ms(solve, 5)

    per = {'lsa_host': scipy_hungarian_match, 'auction': None}
    ms = {k: [] for k in per}
    for _ in range(steps):
        for k, fn in per.items():
            with Matcher(fn):
                t0 = time.perf_counter()
                ts, tt, m = step(ts, tt)
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(float(m['total_loss'])):
                raise AssertionError(f'{name}: non-finite loss with {k}')
    out = {'shapes': shapes, 'valid_gt': n_gt, 'problems': stats['problems'],
           'lsa_host_ms': scipy_ms, 'auction_ms': auction_ms,
           'auction_eager_ms': eager_ms, 'iterations': stats['iterations'],
           'greedy': stats['greedy'], 'bitwise_card_cpu': bitwise,
           'gap_max': max(gaps), 'gap_mean': float(np.mean(gaps)),
           'gap_problems': len(gaps),
           'ms_step_lsa_host': statistics.median(ms['lsa_host']),
           'ms_step_auction': statistics.median(ms['auction']),
           'first_step_ms': first_ms}
    log(f'  {name}: costs {shapes}, {n_gt} valid GT, {stats["problems"]} '
        f'problems; matching host ms: lsa_host {scipy_ms:.2f}, auction '
        f'{auction_ms:.2f} ({stats["iterations"]} iterations, greedy '
        f'{stats["greedy"]}; its {matching.CHECK_EVERY}-iteration chunks '
        f'replayed from a CUDA graph, {eager_ms:.2f} launched op by op); '
        f'auction bitwise equal '
        f'card vs CPU; cost gap to scipy over {len(gaps)} problems: max '
        f'{max(gaps):.4%}, mean {np.mean(gaps):.4%}; ms/step (median of '
        f'{steps}, alternating) lsa_host {out["ms_step_lsa_host"]:.2f}, '
        f'auction {out["ms_step_auction"]:.2f} [{card}]')
    return out


def soak_phase(card):
    """Phase 20b: cli.soak at full width, cut in depth."""
    with tempfile.TemporaryDirectory(prefix='far3d_soak_') as tmp:
        t0 = time.perf_counter()
        _build.reset_launch_counts()
        out = cli_soak.run_soak(iters=SOAK_ITERS, switch_at=SOAK_SWITCH,
                                resume_iters=SOAK_RESUME,
                                log=f'{tmp}/soak.jsonl', work=f'{tmp}/ckpt')
        launches = {k: _build.launch_counts[k] for k in MSDA_NAMES}
        wall = time.perf_counter() - t0
    steps = 3 * SOAK_RESUME + SOAK_ITERS       # phase 1's four runs, phase 2
    if launches != {k: LAYERS_PER_FRAME * steps for k in MSDA_NAMES}:
        raise AssertionError(f'soak launches {launches}, expected '
                             f'{LAYERS_PER_FRAME} of each in each of {steps} '
                             'steps')
    res = out['resume']
    if res['repeat_diffs'] or res['resume_diffs']:
        raise AssertionError(f'soak resume checks: repeat '
                             f'{res["repeat_diffs"][:8]}, resume '
                             f'{res["resume_diffs"][:8]}')
    if not out['stability']['finite']:
        raise AssertionError('soak: a non-finite window')
    s_it = [w['s_per_it'] for w in out['stability']['windows']]
    log(f'  both resume checks bitwise over {res["compared"]} tensors; '
        f'{len(s_it)} windows finite, s/it {min(s_it):.3f}-{max(s_it):.3f}; '
        f'launches {launches} ({LAYERS_PER_FRAME} of each in each of {steps} '
        f'steps); {wall:.1f} s [{card}]')
    return {'compared': res['compared'],
            'windows': out['stability']['windows'],
            'step0': out['stability']['step0'], 'launches': launches,
            'wall_s': wall}


def closed_loop_phase(card):
    """Phase 20c: run_closed_loop_full at full width, cut in depth."""
    real_step, step_ms, switch = runner.train_step, [], []

    def timed_step(*args, use_gt_depth):
        switch.append(use_gt_depth)
        t0 = time.perf_counter()
        out = real_step(*args, use_gt_depth=use_gt_depth)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    with tempfile.TemporaryDirectory(prefix='far3d_ovf_') as tmp:
        t0 = time.perf_counter()
        runner.train_step = timed_step
        try:
            _build.reset_launch_counts()
            curve = cli_overfit_full.run_closed_loop_full(
                tmp, CLOSED_STEPS, eval_every=CLOSED_STEPS,
                gt_depth_until=CLOSED_STEPS // 2)
            launches = {k: _build.launch_counts[k] for k in MSDA_NAMES}
        finally:
            runner.train_step = real_step
        wall = time.perf_counter() - t0
        n_eval = len(AV2SequenceDataset(f'{tmp}/infos.pkl', tmp, split='val',
                                        seq_split_num=1, test_mode=False))
    if switch != [i < CLOSED_STEPS // 2 for i in range(CLOSED_STEPS)]:
        raise AssertionError(f'GT depth by step {switch}')
    want = {msda_cuda.FWD: LAYERS_PER_FRAME * (CLOSED_STEPS + n_eval),
            msda_cuda.DVAL: LAYERS_PER_FRAME * CLOSED_STEPS,
            msda_cuda.DATTN: LAYERS_PER_FRAME * CLOSED_STEPS}
    if launches != want:
        raise AssertionError(f'closed loop launches {launches}, expected '
                             f'{want} (6 a step, 6 an eval frame forward)')
    last = curve[-1]
    if not (len(curve) == 1 and last['iter'] == CLOSED_STEPS
            and np.isfinite(last['mAP']) and np.isfinite(last['CDS'])):
        raise AssertionError(f'closed loop curve {curve}')
    ms_step = statistics.median(step_ms[2:])
    log(f'  {CLOSED_STEPS} steps (GT depth until {CLOSED_STEPS // 2}), one '
        f'eval of {n_eval} frames: mAP {last["mAP"]:.4f}, CDS '
        f'{last["CDS"]:.4f}; launches {launches} ({LAYERS_PER_FRAME} of each '
        f'a step, msda_fwd also {LAYERS_PER_FRAME} an eval frame); '
        f'{ms_step:.2f} ms/step (median of steps 2..{CLOSED_STEPS - 1}); '
        f'eval {last["eval_s"]:.1f} s; {wall:.1f} s with the dataset and '
        f'cache [{card}]')
    return {'curve': curve, 'launches': launches, 'eval_frames': n_eval,
            'ms_step': ms_step, 'wall_s': wall}


def phase20(card):
    log('== phase 20a: matching on both families\' training steps, full width')
    match = {'far3d': matching_family('Far3D', train_entry, card),
             'streampetr': matching_family('StreamPETR', petr_train_entry,
                                           card)}
    torch.cuda.empty_cache()
    log('== phase 20b: cli.soak at full width, cut in depth')
    soak = soak_phase(card)
    torch.cuda.empty_cache()
    log('== phase 20c: cli.overfit_full at full width, cut in depth')
    closed = closed_loop_phase(card)
    torch.cuda.empty_cache()
    return {'card': card, 'matching': match, 'soak': soak,
            'closed_loop': closed}


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
    # phase 16's dataset and checkpoint serve phases 17 and 19d
    data_tmp = tempfile.TemporaryDirectory(prefix='far3d_data_')
    data_dir = Path(data_tmp.name)
    data = dataset_path(cfg, dev, card, data_dir)
    torch.cuda.empty_cache()

    log('== phase 17: the int8 serving path: qconv and ese_requant at '
        'small and awkward shapes, Far3DConfig() through quant_backbone, '
        'every conv site and block tail, times, and phase 16\'s eval '
        'through cli.test --quant --map-root --submission')
    qconv_small_shapes(dev)
    serve = serving_path(cfg, dev, card)
    torch.cuda.empty_cache()
    serve_cli = serving_cli(data_dir, card)
    torch.cuda.empty_cache()

    log('== phase 18: StreamPETR at full width: 6 cameras of 320x800, bf16 '
        'and int8 serving (qconv and ese_requant at its stage shapes), the '
        'cross attention, training, and the nuScenes path through its CLIs')
    log('== phase 18a: streaming frames, bf16 then int8')
    petr = petr_serving_path(dev, card)
    torch.cuda.empty_cache()
    log('== phase 18d: full-width StreamPETR training (petr_train_entry); '
        'tiny StreamPETR train steps card vs CPU')
    tiny_petr_train_card_vs_cpu(dev)
    petr_train = petr_train_path(card)
    torch.cuda.empty_cache()
    log('== phase 18e: a nuScenes PNG dataset -> cli.train_nusc -> '
        'cli.test_nusc (bf16, --quant)')
    with tempfile.TemporaryDirectory(prefix='far3d_nusc_') as tmp:
        petr_data = petr_dataset_path(Path(tmp), card)
    torch.cuda.empty_cache()

    log('== phase 19: data parallelism over torch.distributed and camera '
        'sharding (far3d_tpu_torch/parallel/)')
    with tempfile.TemporaryDirectory(prefix='far3d_dp_') as work:
        work = Path(work)
        log('== phase 19a: NCCL at world size 1: run_training at full width')
        dp_a = dp_nccl_world1(work, card, ms_step)
        log('== phase 19b: two gloo ranks on this card, full width, 3 steps')
        dp_b = dp_gloo_full(work, card)
        log('== phase 19c: tiny DP against one process at batch 2, on the '
            'card')
        dp_c = dp_tiny(work, card)
        log('== phase 19d: cli.test on two ranks against one, phase 16\'s '
            'dataset')
        dp_d = dp_cli_test(work, data_dir, card)
    data_tmp.cleanup()
    log('== phase 19e: camera-sharded inference, 7 slices on this card')
    cam = cam_shard_phase(cfg, dev, card, ms_frame)
    torch.cuda.empty_cache()

    log('== phase 20: training at deployment scale: matching, the soak, '
        'the closed loop')
    p20 = phase20(card)
    dp_launches = {
        name: {'19a_nccl_world1': dp_a['launches'][name],
               '19b_rank0': dp_b[0]['launches'][name],
               '19b_rank1': dp_b[1]['launches'][name],
               **({'19e_cam_shard': cam['launches']}
                  if name == msda_cuda.FWD else {})}
        for name in MSDA_NAMES}
    p20_launches = {name: {'20b_soak': p20['soak']['launches'][name],
                           '20c_overfit_full':
                               p20['closed_loop']['launches'][name]}
                    for name in MSDA_NAMES}

    petr_common = {'streampetr_ms_per_frame_bf16': petr['bf16_frame_ms'],
                   'streampetr_ms_per_frame_int8': petr['int8_frame_ms'],
                   'streampetr_ms_per_step': petr_train['ms_step'],
                   'streampetr_peak_gib_train': petr_train['peak_gib']}

    def petr_launches(*names):
        """Phase 18's launches of these counters: StreamPETR's frames (bf16
        and int8) and its training steps."""
        return {'streampetr_launches': sum(
                    petr['bf16_launches'].get(n, 0) + petr['launches'].get(n, 0)
                    for n in names),
                'streampetr_train_launches': sum(
                    petr_train['launches'].get(n, 0) for n in names)}

    common = {'route': 'cuda', 'ms_per_frame': ms_frame, 'ms_per_step': ms_step,
              'peak_gib_train': train['peak_gib'], **petr_common}
    bwd_plain = 'msda_backward_reference: autograd through msda_reference, f32'
    bwd_lib = 'backward of F.grid_sample per level + einsum (composite, f32)'
    kernels = {'kernels': [{
        'name': 'msda_fwd', **common, **petr_launches('msda_fwd'),
        'dp_launches': dp_launches[msda_cuda.FWD],
        'training_launches': p20_launches[msda_cuda.FWD],
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
        'name': 'msda_dval', **common, **petr_launches('msda_dval'),
        'dp_launches': dp_launches[msda_cuda.DVAL],
        'training_launches': p20_launches[msda_cuda.DVAL],
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
        'name': 'msda_dattn', **common, **petr_launches('msda_dattn'),
        'dp_launches': dp_launches[msda_cuda.DATTN],
        'training_launches': p20_launches[msda_cuda.DATTN],
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
        'name': 'osa_fused', **common, **petr_launches('osa_fused'),
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
    }, {
        'name': 'qconv', **common,
        'source': 'far3d_tpu_torch/csrc/qconv.cu',
        'replaces': 'far3d_tpu/ops/quant.py:228',
        'replaces_note': 'an XLA s8 convolution with a fused epilogue, no '
                         'Pallas kernel',
        'launches': serve['launches']['qconv_tma']
        + serve['launches']['qconv_mma'],
        'launches_by_route': {'tma_wgmma': serve['launches']['qconv_tma'],
                              'mma_sync': serve['launches']['qconv_mma']},
        'site_routes': serve['site_routes'],
        'launches_per_frame': QCONV_PER_FRAME,
        'max_abs_err': 0.0, 'bitwise_sites': QCONV_PER_FRAME,
        'ms': serve['ms'], 'kernel_ms': serve['ms'],
        'ms_cold_l2': serve['cold'], 'first_version_ms': serve['first_ms'],
        'first_version': 'the mma.sync kernel of the same file on every site',
        'plain_ms': serve['plain_ms'],
        'plain': 'qconv_reference: float64 unfold x weights, the same '
                 'epilogue (sums over the frame\'s 99 sites)',
        'bound_ms': serve['bound_ms'], 'bound_by': serve['bound_by'],
        'int8_tera_ops_per_frame': serve['ops'] / 1e12,
        'library_ms': serve['library_ms'],
        'library': 'im2col (pad, k*k slices, cat) + torch._int_mm + the same '
                   'epilogue, summed over the 99 sites',
        'cudnn_bf16_conv_ms': serve['cudnn_ms'],
        'int8_backbone_ms': serve['int8_backbone_ms'],
        'int8_backbone_qconv_ms': serve['int8_qconv_ms'],
        'bf16_backbone_ms': serve['bf16_backbone_ms'],
        'ms_per_frame_int8': serve['int8_frame_ms'],
        'ms_per_frame_int8_again': serve['int8_again_ms'],
        'ms_per_frame_bf16': serve['bf16_frame_ms'],
        'stage_rel_l2': serve['rel_l2'],
        'cli_test': serve_cli,
        **petr_launches(*qconv_cuda.NAMES.values()),
        'streampetr_launches_by_route': {
            'tma_wgmma': petr['launches'][qconv_cuda.NAMES['tma']],
            'mma_sync': petr['launches'][qconv_cuda.NAMES['mma']]},
        'streampetr_site_routes': petr['site_routes'],
        'streampetr_ms': petr['ms'], 'streampetr_ms_cold_l2': petr['cold'],
        'streampetr_first_version_ms': petr['first_ms'],
        'streampetr_plain_ms': petr['plain_ms'],
        'streampetr_bound_ms': petr['bound_ms'],
        'streampetr_bound_by': petr['bound_by'],
        'streampetr_library_ms': petr['library_ms'],
        'streampetr_cudnn_bf16_conv_ms': petr['cudnn_ms'],
        'streampetr_int8_tera_ops_per_frame': petr['ops'] / 1e12,
        'streampetr_int8_backbone_ms': petr['int8_backbone_ms'],
        'streampetr_bf16_backbone_ms': petr['bf16_backbone_ms'],
        'streampetr_stage_rel_l2': petr['rel_l2'],
    }, {
        'name': 'ese_requant', **common,
        'source': 'far3d_tpu_torch/csrc/ese_requant.cu',
        'replaces': 'far3d_tpu/ops/quant.py:252',
        'replaces_note': 'the eSE gate, identity add and requantize that XLA '
                         'fuses after the concat conv, no Pallas kernel',
        'launches': serve['launches']['ese_requant'],
        'launches_per_frame': BLOCKS_PER_FRAME,
        'max_abs_err': 0.0, 'bitwise_repeatable': True,
        'torch_sequence_equal_share': serve['tail']['equal_share'],
        'torch_sequence_max_abs_err': serve['tail']['max_diff'],
        'ms': serve['tail']['ms'], 'kernel_ms': serve['tail']['ms'],
        'ms_cold_l2': serve['tail']['cold'],
        'plain_ms': serve['tail']['plain_ms'],
        'plain': 'ese_requant_reference: the PyTorch passes from the same '
                 'gate (sums over the frame\'s 16 blocks)',
        'bound_ms': serve['tail']['bound_ms'], 'bound_by': 'bytes',
        'gb_per_frame': serve['tail']['nbytes'] / 1e9,
        'library_ms': serve['tail']['library_ms'],
        'library': 'the PyTorch sequence it replaces (mean, gate, product, '
                   'identity add, requantize), summed over the 16 blocks',
        'int8_backbone_ese_requant_ms': serve['int8_tail_ms'],
        **petr_launches(ese_requant_cuda.NAME),
        'streampetr_ms': petr['tail']['ms'],
        'streampetr_ms_cold_l2': petr['tail']['cold'],
        'streampetr_plain_ms': petr['tail']['plain_ms'],
        'streampetr_bound_ms': petr['tail']['bound_ms'],
        'streampetr_library_ms': petr['tail']['library_ms'],
        'streampetr_torch_sequence_equal_share':
            petr['tail']['equal_share'],
    }]}
    log('StreamPETR (phase 18): ' + json.dumps({
        'cross_attention': petr['attn'],
        'bf16_frame_busy_ms': petr['bf16_frame_busy_ms'],
        'int8_backbone_qconv_ms': petr['int8_qconv_ms'],
        'int8_backbone_ese_requant_ms': petr['int8_tail_ms'],
        'off_tma_sites': petr['off_tma'], 'train': petr_train,
        'dataset_cli': petr_data}))
    log('Parallel (phase 19): ' + json.dumps({
        'nccl_world1': dp_a, 'gloo_two_ranks_one_card': dp_b,
        'tiny_dp_vs_one': dp_c, 'cli_test_two_ranks': dp_d,
        'cam_shard': cam}))
    log('Training at scale (phase 20): ' + json.dumps(p20))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    if len(sys.argv) > 2 and sys.argv[1] == '--rank-worker':
        sys.exit(rank_worker(*sys.argv[2:]))
    sys.exit(main())
