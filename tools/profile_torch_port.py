#!/usr/bin/env python3
"""Where a frame's (or a training step's) time goes in the PyTorch port, on
one NVIDIA card.

    python tools/profile_torch_port.py [--frames 5] [--out chiprun_out/profile_torch_port.json]
    python tools/profile_torch_port.py --train [--frames 4] [--out chiprun_out/profile_torch_train.json]

Runs full-width Far3DConfig() streaming inference (7 cameras, 640x960, bf16
images, seeded random weights) through far3d_tpu_torch.entry, warms up, then
measures steady frames three ways:
  * wall time per frame (host clock around work ending in a synchronize);
  * device time per stage, from CUDA events recorded by forward hooks on the
    detector's children (backbone, neck, 2D head, FarHead), the decoder and
    the MSDA sampler (the stages' spans include any idle gaps inside them);
  * torch.profiler over the same frames: the summed time of every device
    kernel, the device's idle share of the wall time, and the top kernels.
With --train it profiles full-width training steps through
far3d_tpu_torch.entry.train_entry instead: wall time per step, the host time
of each labelled part of the step (train.forward, train.loss_3d with the
matching's host synchronization, train.loss_2d, train.backward,
train.optimizer), device busy time and idle share, peak memory and the top
kernels.
Prints a summary and writes it as JSON. Needs a card; raises without one.
"""

import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from far3d_tpu_torch.config import Far3DConfig  # noqa: E402
from far3d_tpu_torch.entry import entry, train_entry  # noqa: E402
from far3d_tpu_torch.ops import _build  # noqa: E402


def _stage_hooks(model):
    """Forward hooks that record CUDA events around each named stage; returns
    (events per stage, handles)."""
    head = model.pts_bbox_head
    decoder = head.transformer['decoder']
    stages = {'backbone': model.img_backbone, 'neck': model.img_neck,
              'roi_head_2d': model.img_roi_head, 'farhead': head,
              'farhead.decoder': decoder}
    for i, layer in enumerate(decoder.layers):
        stages[f'msda.layer{i}'] = layer.attentions[1].sampler
    events = collections.defaultdict(list)
    handles = []
    for name, mod in stages.items():
        def pre(m, a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev, None])

        def post(m, a, o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post))
    return events, handles


def _device_kernels(prof):
    """(ms per kernel name, launches per kernel name) of a profile's device
    activity; the device-side copies of record_function labels (user
    annotations, e.g. train.forward) are spans, not work, and are left out."""
    kernels = collections.Counter()
    counts = collections.Counter()
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, 'is_user_annotation', False)
                and not ev.name.startswith(('train.', 'Optimizer.'))):
            kernels[ev.name] += ev.time_range.elapsed_us() / 1e3
            counts[ev.name] += 1
    return kernels, counts


def profile_train(args, card):
    """Full-width training steps: wall, labelled host parts, device busy
    time and idle share, top kernels, peak memory."""
    step, (state, temporal) = train_entry(Far3DConfig())
    for _ in range(args.warmup):
        state, temporal, _ = step(state, temporal)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        state, temporal, _ = step(state, temporal)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            state, temporal, _ = step(state, temporal)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    parts = collections.Counter()
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith('train.')):
            parts[ev.name] += ev.time_range.elapsed_us() / 1e3
    kernels, counts = _device_kernels(prof)
    busy = sum(kernels.values())
    n = args.frames
    result = {
        'card': card, 'steps': n,
        'wall_ms_per_step_median': statistics.median(wall),
        'wall_ms_per_step': wall,
        'peak_memory_gib': peak,
        'host_ms_per_step_by_part': {k: v / n for k, v in parts.items()},
        'profiled_wall_ms_per_step': prof_wall / n,
        'device_busy_ms_per_step': busy / n,
        'device_idle_share': 1.0 - busy / n / statistics.median(wall),
        'device_idle_share_profiled': 1.0 - busy / prof_wall,
        'device_kernel_launches_per_step': sum(counts.values()) / n,
        'top_kernels': [{'kernel': k[:120], 'ms_per_step': v / n,
                         'launches_per_step': counts[k] / n}
                        for k, v in kernels.most_common(20)],
        'msda_kernels': {k[:60]: {'ms_per_step': v / n,
                                  'launches_per_step': counts[k] / n}
                         for k, v in kernels.items() if 'msda' in k},
    }
    for k in ('card', 'wall_ms_per_step_median', 'peak_memory_gib',
              'profiled_wall_ms_per_step', 'device_busy_ms_per_step',
              'device_idle_share', 'device_idle_share_profiled',
              'device_kernel_launches_per_step'):
        print(f'{k}: {result[k]}')
    for k, v in sorted(result['host_ms_per_step_by_part'].items()):
        print(f'  host {k}: {v:.3f} ms')
    for k, v in result['msda_kernels'].items():
        print(f"  msda kernel {k}: {v['ms_per_step']:.3f} ms, "
              f"x{v['launches_per_step']:.1f}")
    for t in result['top_kernels']:
        print(f"  {t['ms_per_step']:8.3f} ms  x{t['launches_per_step']:6.1f}  "
              f"{t['kernel']}")
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=5,
                    help='frames (or steps with --train) measured')
    ap.add_argument('--warmup', type=int, default=3)
    ap.add_argument('--train', action='store_true',
                    help='profile full-width training steps')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()          # every nvcc run started together
    if args.train:
        result = profile_train(args, card)
        out = pathlib.Path(args.out or 'chiprun_out/profile_torch_train.json')
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        return 0

    step, (state,) = entry(Far3DConfig())
    dev = torch.device('cuda')
    ones = torch.ones(1, device=dev)
    dets, state = step(state)
    for _ in range(args.warmup):
        dets, state = step(state, prev_exists=ones)
    torch.cuda.synchronize()

    # 1) wall time and per-stage device spans
    events, handles = _stage_hooks(step.model)
    wall = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        dets, state = step(state, prev_exists=ones)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    for h in handles:
        h.remove()
    stage_ms = {}
    for name, pairs in events.items():
        per = [a.elapsed_time(b) for a, b in pairs]
        if name.startswith('msda.'):
            stage_ms.setdefault('msda (6 layers)', []).extend(per)
        else:
            stage_ms[name] = statistics.median(per)
    msda = stage_ms.pop('msda (6 layers)')
    stage_ms['msda (6 layers)'] = sum(msda) / args.frames

    # 2) profiler: device busy time and the top kernels
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            dets, state = step(state, prev_exists=ones)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels, counts = _device_kernels(prof)
    busy = sum(kernels.values())
    top = [{'kernel': k[:120], 'ms_per_frame': v / args.frames,
            'launches_per_frame': counts[k] / args.frames}
           for k, v in kernels.most_common(15)]

    result = {
        'card': card, 'frames': args.frames,
        'wall_ms_per_frame_median': statistics.median(wall),
        'wall_ms_per_frame': wall,
        'stage_device_ms_per_frame': stage_ms,
        'profiled_wall_ms_per_frame': prof_wall / args.frames,
        'device_busy_ms_per_frame': busy / args.frames,
        # idle share against the unprofiled wall time; the profiler's own
        # overhead stretches the profiled frames
        'device_idle_share': 1.0 - busy / args.frames
        / statistics.median(wall),
        'device_idle_share_profiled': 1.0 - busy / prof_wall,
        'device_kernel_launches_per_frame': sum(counts.values()) / args.frames,
        'top_kernels': top,
    }
    for k in ('card', 'wall_ms_per_frame_median', 'profiled_wall_ms_per_frame',
              'device_busy_ms_per_frame', 'device_idle_share',
              'device_idle_share_profiled',
              'device_kernel_launches_per_frame'):
        print(f'{k}: {result[k]}')
    for k, v in stage_ms.items():
        print(f'  stage {k}: {v:.3f} ms')
    for t in top:
        print(f"  {t['ms_per_frame']:8.3f} ms  x{t['launches_per_frame']:6.1f}  "
              f"{t['kernel']}")
    out = pathlib.Path(args.out or 'chiprun_out/profile_torch_port.json')
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
