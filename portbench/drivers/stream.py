"""The streaming driver: one camera rig at batch 1, closed loop (the
temporal memory makes frame n + 1 wait for frame n).

A frame runs from handing the uint8 camera frame (pinned host memory) and
its pose to the program to its detections on the host: the upload, the
model, the decode and the copy back. ``frame_ms`` is the window over the
frames completed in it; ``frame_p95_ms`` the 95th percentile of every
frame's latency in the window.

Set-up makes the weights on the card from the seed, builds the program's
model, calibrates the int8 backbone (``backbone: int8``) on two seeded
frames that the window never sends, and warms the cell's shapes with a few
frames. The window then starts a fresh stream. The checked frames' inputs,
the state carried into them and the program's stages' inputs and outputs
are kept (hooks placed for those frames alone); once the window has closed
and the program is freed, the reference computes each stage from the same
inputs, state and outputs of the stage before (``harness/compare.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from harness import (compare, family as fam, hooks, hostspeed, traffic as tr,
                     work)


class Rig:
    """One side's model and what it needs to serve a frame."""

    def __init__(self, family, device, seed, traffic, weights, qmax=None):
        self.f = family
        self.device = device
        self.model = family.build(weights, device)
        self.rig = family.rig(device)
        self.quant = None
        if traffic['backbone'] == 'int8':
            calib = calibration_frames(family, seed, device)
            with _int_range(qmax):
                self.quant = family.quantize(self.model, calib)

    def batch(self, images, small: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The frame's inputs on the device from its uploaded pieces."""
        pose, pose_inv = small[:16].view(1, 4, 4), small[16:32].view(1, 4, 4)
        return dict(images=images, timestamp=small[32:33],
                    prev_exists=small[33:34], ego_pose=pose,
                    ego_pose_inv=pose_inv, **self.rig)


def _int_range(qmax):
    """The reference's integer range lowered to `qmax` (the control), or
    nothing."""
    if qmax is None:
        return contextlib.nullcontext()
    from reference.ops.qconv import int_range
    return int_range(qmax)


def calibration_frames(family, seed, device) -> List[torch.Tensor]:
    pool = tr.image_pool(2, family.num_cams, family.input_hw,
                         tr.sub_seed(seed, 7), device)
    return [pool[i].to(device) for i in range(2)]


def pack(frame: Dict) -> np.ndarray:
    """A frame's pose, inverse pose, timestamp and prev_exists as 34
    float32 values, uploaded in one copy."""
    return np.concatenate([frame['ego_pose'].ravel(),
                           frame['ego_pose_inv'].ravel(),
                           [frame['timestamp'], frame['prev_exists']]]
                          ).astype(np.float32)


class Server:
    """The program's side: ``serve(i, state)`` runs frame i of the stream
    and returns (detections on the host, new state)."""

    def __init__(self, rig: Rig, stream: tr.Stream, pool: torch.Tensor,
                 step):
        self.rig, self.stream, self.pool, self.step = rig, stream, pool, step
        self.small = tr.pinned(torch.empty(34, dtype=torch.float32),
                               rig.device)

    def serve(self, i: int, state):
        f = self.stream.frame(i)
        images = self.pool[f['pool']].to(self.rig.device, non_blocking=True)
        self.small.numpy()[:] = pack(f)
        small = self.small.to(self.rig.device, non_blocking=True)
        dets, state = self.step(self.rig.model, state,
                                self.rig.batch(images, small), self.rig.quant)
        return {k: v.cpu() for k, v in dets.items()}, state


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device='cuda', control=None) -> Dict:
    """One run of a streaming cell; returns the driver's result (see
    ``run.py``). `control` puts the reference in the program's place, its
    image side in the configuration's dtype (bf16), every convolution and
    linear layer one precision lower (``lower``) and the integer backbone
    at a lower range (``qmax``: 7 is int4); only the readings and the
    control tests pass it."""
    t = dict(cell.traffic)
    device = torch.device(device)
    port = fam.load(cell.config, 'port')
    ref_family = fam.load(cell.config, 'reference')
    stream = tr.Stream(t, seed)
    pool = tr.image_pool(t['pool_frames'], port.num_cams, port.input_hw,
                         seed, device)
    weights = port.weights(seed, device)
    if control:                                   # the reference as program
        side = ref_family
        rig = Rig(ref_family, device, seed, t, weights,
                  qmax=control.get('qmax'))
        server = Server(rig, stream, pool, _reference_step(ref_family,
                                                           control))
    else:
        side = port
        rig = Rig(port, device, seed, t, weights)
        server = Server(rig, stream, pool, port.infer_step())
    del weights

    # warm-up: a fresh stream through a scene change
    state = side.init_state(device)
    for i in range(t['warmup_frames']):
        _, state = server.serve(i, state)
    _, state = server.serve(t['scene_frames'], state)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    # the measured window; set-up's objects moved out of the collector's
    # sight, so that its passes in the window scan the window's alone
    gc.collect()
    gc.freeze()
    checks = set(tr.check_frames(t, seed))
    stages = side.stages(rig.model)
    inputs = {'decoder', *range(len(side.decoder_layers(rig.model)))}
    kept: Dict[int, Dict] = {}
    state = side.init_state(device)
    lat: List[float] = []
    i = 0
    host_before = hostspeed.snapshot()
    t0 = time.perf_counter()
    end = t0
    while end - t0 < seconds:
        state_in = state
        with hooks.Capture(stages if i in checks else {}, inputs) as cap:
            a = time.perf_counter()
            dets, state = server.serve(i, state)
            end = time.perf_counter()
        if i in checks:
            kept[i] = dict(state_in=state_in, dets=dets, state_out=state,
                           taken=cap.taken)
        lat.append(end - a)
        i += 1
    window = end - t0
    hostspeed.report(host_before, hostspeed.snapshot())
    print('frame latency ms in order: '
          + ' '.join(f'{x * 1e3:.1f}' for x in lat), file=sys.stderr)
    frames = i
    result = dict(attempted=frames, failed=0, setup_s=setup_s,
                  e2e={'frame_ms': window / frames * 1e3,
                       'frame_p95_ms': float(np.percentile(lat, 95)) * 1e3},
                  frames=frames, window_s=window,
                  latency_ms={q: float(np.percentile(lat, q)) * 1e3
                              for q in (5, 50, 99, 100)})

    if trace:
        result['traced'] = traced_window(server, rig, i, state, t)
    result['memory_peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == 'cuda' else 0)

    # free the program, then the reference on the checked frames
    del server, rig, pool, state
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    result['numbers'], result['flops'] = check(
        ref_family, cell, t, seed, device, kept, count=trace)
    return result


def _reference_step(ref_family, control: Dict):
    """The reference in the program's place (the control): one frame, the
    uint8 images normalized to bf16 as the program's are, then its decode,
    in the program's call signature."""
    decode = ref_family.mod('models.detector').decode_boxes
    layers = ref_family.mod('models.layers')
    head = getattr(ref_family.cfg, 'head', ref_family.cfg)
    mean, std = ref_family.image_norm()

    @torch.inference_mode()
    def step(model, state, batch, quant):
        batch = dict(batch)
        m = torch.tensor(mean, device=batch['images'].device)
        s = torch.tensor(std, device=batch['images'].device)
        batch['images'] = ((batch['images'].float() - m) / s).to(
            torch.bfloat16)
        lower = (layers.one_step_lower() if control.get('lower')
                 else contextlib.nullcontext())
        with _int_range(control.get('qmax')), lower:
            out = model(state=state, quant_backbone=quant,
                        **{k: batch[k] for k in ref_family.batch_keys})
        dets = decode(out['all_cls_scores'][-1], out['all_bbox_preds'][-1],
                      out['query_valid'], head.max_decode_num,
                      head.post_center_range)
        return dets, out['state']
    return step


def traced_window(server: Server, rig: Rig, i: int, state, t: Dict) -> Dict:
    """`trace_frames` frames with the stage spans hooked on (CUDA events,
    no profiler, so the spans carry no profiler overhead) and the MSDA
    operands captured, their least time counted after each frame, then as
    many frames under the profiler; returns what the metrics read."""
    from harness.trace import Trace, host_span, profiled
    n = t['trace_frames']
    spans = hooks.Spans()
    rig.f.spans(rig.model, spans)
    msda_ops: List = []
    handles = hooks.capture_msda(hooks.msda_modules(rig.model), msda_ops,
                                 limit=10 ** 6)
    bound_s, calls = 0.0, 0
    try:
        for k in range(n):
            _, state = server.serve(i + k, state)
            for shapes, value, loc, weights in msda_ops:
                nbytes, flops = work.msda_fwd_needs(value, shapes, loc,
                                                    weights)
                bound_s += work.bound_seconds(nbytes, flops,
                                              work.PEAKS['f32_flops'])
            calls += len(msda_ops)
            msda_ops.clear()
    finally:
        spans.remove()
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    spans_ms = spans.ms_each()

    def frames():
        nonlocal state
        with record_function('bench.window'):
            for k in range(n, 2 * n):
                with record_function('bench.frame'):
                    _, state = server.serve(i + k, state)
        torch.cuda.synchronize()

    _, events = profiled(frames)
    return dict(trace=Trace(events, host_span(events, 'bench.window')),
                frames=n, spans_ms=spans_ms,
                msda_fwd=dict(bound_s=bound_s, calls=calls))


def check(ref_family, cell, t, seed, device, kept: Dict[int, Dict],
          count: bool):
    """The reference on each checked frame, stage by stage, from the
    frame's inputs, the state the program carried into it and the
    program's own output of the stage before (see ``harness/compare.py``);
    returns (compared numbers, FLOP counts of one reference frame when
    `count`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = ref_family.weights(seed, device)
    rig = Rig(ref_family, device, seed, t, weights)
    del weights
    stream = tr.Stream(t, seed)
    pool = tr.image_pool(t['pool_frames'], ref_family.num_cams,
                         ref_family.input_hw, seed, device)
    model = rig.model
    decoder = ref_family.decoder(model)
    ref_layers = ref_family.decoder_layers(model)
    head_cfg = getattr(ref_family.cfg, 'head', ref_family.cfg)
    decode_boxes = ref_family.mod('models.detector').decode_boxes

    def decode(cls, bbox, valid):
        return decode_boxes(cls, bbox, valid, head_cfg.max_decode_num,
                            head_cfg.post_center_range)

    gaps, flops = [], None
    for i in sorted(kept):
        k = kept[i]
        taken = k['taken']
        f = stream.frame(i)
        small = torch.from_numpy(pack(f)).to(device)
        batch = rig.batch(pool[f['pool']].to(device), small)
        state_in = ref_family.state_to(k['state_in'])
        if count and flops is None:
            flops = count_frame(ref_family, rig, state_in, batch)
        with torch.inference_mode():
            with hooks.Capture({'neck': model.img_neck}) as cap:
                ref_family.forward(model, state_in, batch, rig.quant)
            g = {'neck_rel': compare.worst_rel(taken['neck'][1],
                                               cap.out('neck'))}
            g.update(ref_family.head2d_gaps(model, taken))
            with hooks.Capture({'decoder': decoder}) as cap, \
                    hooks.replaced_output(decoder, taken['decoder'][1]):
                head = ref_family.head_on(model, taken, batch, state_in)
        prog_head = taken['head'][1]
        g['head_in_rel'] = compare.worst_rel(taken['decoder'][0],
                                             cap.taken['decoder'][0])
        g['decoder_step_rel'] = max(compare.layer_steps(
            {j: taken[j] for j in range(len(ref_layers))}, ref_layers))
        g['branch_rel'] = compare.worst_rel(
            [prog_head['all_cls_scores'], prog_head['all_bbox_preds']],
            [head['all_cls_scores'], head['all_bbox_preds']])
        g['decode_wrong'] = compare.decode_wrong(k['dets'], prog_head, decode)
        g['memory_wrong'] = compare.memory_wrong(k['state_out'],
                                                 head['state'])
        gaps.append(g)
    numbers = {name: max(g[name] for g in gaps) for name in gaps[0]}
    numbers['frames_checked'] = len(kept)
    return numbers, flops


def count_frame(ref_family, rig: Rig, state, batch) -> Dict:
    """FLOP of one reference frame: the matmuls, convolutions and attention
    that ``FlopCounterMode`` sees, the MSDA sampling counted from its
    operands, and the int8 backbone's conv operations from the shapes."""
    msda_ops: List = []
    handles = hooks.capture_msda(hooks.msda_modules(rig.model), msda_ops,
                                 limit=10 ** 6)
    try:
        _, counted = work.count_flops(
            lambda: ref_family.forward(rig.model, state, batch, rig.quant))
    finally:
        for h in handles:
            h.remove()
    sampling = sum(work.msda_sampling_flops(loc.shape[0], loc.shape[1],
                                            len(shapes), loc.shape[2],
                                            value.shape[2])
                   for shapes, value, loc, _ in msda_ops)
    int8 = 0
    if rig.quant is not None:
        cfg = ref_family.cfg
        int8 = sum(s['ops'] for s in work.qconv_sites(
            dataclasses.asdict(cfg.backbone), ref_family.num_cams,
            ref_family.input_hw))
    return dict(float_flops=counted - int8 + sampling, int8_ops=int8)
