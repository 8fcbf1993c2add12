"""The readers of the program's stage labels (``harness/stages.py`` and the
six ``metrics/*`` that use it) on a trace laid out by hand, and the labels
of a real tiny frame as ``harness/trace.py`` finds them."""

import types

import pytest
import torch

import pb_tiny  # noqa: F401
from harness import spec, stages
from harness.trace import Trace, host_span, profiled

SERVE = ('backbone_busy_ms.serve', 'heads_busy_ms.serve',
         'backbone_idle_ms.serve', 'heads_idle_ms.serve',
         'heads_launches.serve')


def trace_of(labels, ops, window=(0, 1000)):
    """A Trace of `ops` ((start, end, launched at) in ns, kernels) and
    `labels` ({name: [(start, end)]})."""
    t = Trace([], window)
    t.ops = [(s, e, f'kernel{i}', 'kernel', i) for i, (s, e, _) in
             enumerate(ops)]
    t.launch_at = {i: at for i, (_, _, at) in enumerate(ops)}
    t.labels = {k: sorted(v) for k, v in labels.items()}
    t._starts = {k: [s for s, _ in v] for k, v in t.labels.items()}
    return t


# one frame: the backbone in two spans, the neck, a decoder of two layers,
# the memory; a kernel launched between the two backbone spans belongs to
# no stage
FRAME = {'bench.window': [(0, 1000)], 'bench.frame': [(0, 1000)],
         'serve.step': [(0, 950)],
         'model.backbone': [(0, 100), (120, 300)], 'model.neck': [(300, 400)],
         'model.decoder': [(400, 800)],
         'model.decoder.layer': [(400, 600), (600, 800)],
         'model.memory': [(800, 900)]}
OPS = [(100, 200, 50), (200, 300, 150), (350, 400, 350),    # backbone, neck
       (500, 550, 450), (700, 720, 650),                    # two layers
       (900, 950, 850), (950, 980, 110)]                    # memory, none


def ctx_of(trace, frame_ms, **traced):
    return types.SimpleNamespace(traced=dict(trace=trace, frames=1, steps=1,
                                             **traced),
                                 e2e={'frame_ms': frame_ms})


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_busy_counts_a_nested_label_once_and_launches_by_host_time():
    ctx = ctx_of(trace_of(FRAME, OPS), 1e-3)
    assert read('backbone_busy_ms.serve', ctx) == pytest.approx(250e-6)
    # the layers' kernels count once, under model.decoder
    assert read('heads_busy_ms.serve', ctx) == pytest.approx(120e-6)
    assert read('heads_launches.serve', ctx) == 3


def test_idle_shares_out_the_untraced_frames_idle_by_innermost_label(capsys):
    # gaps: 0-100 backbone, 300-350 neck, 400-500 and 550-700 in a layer,
    # 720-900 memory (serve.step is not a stage), 980-1000 the bench's
    # frame: 150 of the 600 ns of traced idle are the backbone's, 430 the
    # heads'; an untraced frame of 0.0007 ms has 0.0003 ms of idle
    ctx = ctx_of(trace_of(FRAME, OPS), 0.7e-3)
    backbone = read('backbone_idle_ms.serve', ctx)
    heads = read('heads_idle_ms.serve', ctx)
    assert backbone == pytest.approx(150 / 600 * 0.3e-3)
    assert heads == pytest.approx(430 / 600 * 0.3e-3)
    assert backbone + heads <= 0.3e-3
    err = capsys.readouterr().err
    assert 'heads_idle_ms.serve: traced idle 0.00043' in err


def test_a_program_without_the_labels_reads_nothing():
    bench_only = {k: v for k, v in FRAME.items() if k.startswith('bench.')}
    bench_only['train.loss_3d'] = [(0, 900)]
    ctx = ctx_of(trace_of(bench_only, OPS), 1e-3)
    for name in SERVE + ('match_ms.train',):
        assert read(name, ctx) is None, name


def test_match_reads_the_auctions_replays_by_their_launch():
    # a graph replay's kernels carry the cudaGraphLaunch's correlation, so
    # they count by its host time even where they run after the label
    labels = {'bench.step': [(0, 1000)], 'train.loss_3d': [(100, 600)],
              'train.match': [(200, 400)]}
    ops = [(150, 200, 120), (410, 470, 300), (480, 500, 390),
           (500, 520, 450)]
    ctx = ctx_of(trace_of(labels, ops), None)
    ctx.traced['steps'] = 2
    assert read('match_ms.train', ctx) == pytest.approx(80e-6 / 2)


def test_the_ports_labels_reach_the_trace_by_name():
    """A tiny frame profiled on the CPU: the labels the readers name are
    user annotations ``Trace`` keeps, and every program label nests in
    the benchmark's window."""
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.entry import entry
    step, (state,) = entry(tiny_test_config(), device='cpu')

    def frames():
        with torch.profiler.record_function('bench.window'):
            step(state)

    _, events = profiled(frames)
    t = Trace(events, host_span(events, 'bench.window'))
    for name in stages.BACKBONE + stages.HEADS + ('model.decoder.layer',
                                                  'serve.step'):
        assert t.labels.get(name), name
    lo, hi = t.window
    assert all(lo <= s and e <= hi for spans in t.labels.values()
               for s, e in spans)
