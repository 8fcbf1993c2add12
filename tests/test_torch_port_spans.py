"""The port's profiler labels (``far3d_tpu_torch/utils/spans.py``) on the CPU
at the tiny sizes: which labels a streaming frame and a training step emit,
how often and inside which, that a frame enters no ``record_function`` when
no profiler runs, and that the labels leave a frame's results bitwise as
they were."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from far3d_tpu_torch.config import tiny_test_config
from far3d_tpu_torch.entry import entry, petr_entry, petr_train_entry, \
    train_entry
from far3d_tpu_torch.models.streampetr import tiny_petr_config
from far3d_tpu_torch.train import losses3d

PREFIXES = ('serve.', 'model.', 'train.')


def _labels(fn):
    """(fn's result, [(name, start, end)] of the package's labels in the
    trace of fn's call, by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith(PREFIXES)]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parent(span, spans):
    """The innermost other label that holds `span`, or None."""
    holders = [s for s in spans if s is not span and _inside(span, s)]
    return min(holders, key=lambda s: s[2] - s[1], default=None)


def _frame_step(family):
    if family == 'far3d':
        cfg = tiny_test_config()
        step, (state,) = entry(cfg, device='cpu')
        return step, state, cfg.decoder.num_layers
    cfg = tiny_petr_config()
    step, (state,) = petr_entry(cfg, device='cpu')
    return step, state, cfg.num_layers


# the model's labels a frame, beside model.decoder.layer (once a layer):
# Far3D normalizes its images in the detector's forward and runs the
# backbone in camera_towers (two model.backbone spans), and builds its
# queries in forward_head and in FarHead (two model.queries spans)
FRAME_LABELS = {
    'far3d': {'serve.step': 1, 'serve.decode': 1, 'model.backbone': 2,
              'model.neck': 1, 'model.head2d': 1, 'model.queries': 2,
              'model.decoder': 1, 'model.branches': 1, 'model.memory': 1},
    'streampetr': {'serve.step': 1, 'serve.decode': 1, 'model.backbone': 1,
                   'model.neck': 1, 'model.queries': 1, 'model.decoder': 1,
                   'model.branches': 1, 'model.memory': 1},
}


@pytest.mark.parametrize('family', ['far3d', 'streampetr'])
def test_a_frame_emits_each_stage_label_inside_serve_step(family):
    step, state, layers = _frame_step(family)
    _, state = step(state)                       # a second, carried frame
    _, spans = _labels(lambda: step(state, prev_exists=torch.ones(1)))
    counts = collections.Counter(name for name, *_ in spans)
    want = dict(FRAME_LABELS[family], **{'model.decoder.layer': layers})
    assert counts == want
    top, = [s for s in spans if s[0] == 'serve.step']
    for s in spans:
        parent = _parent(s, spans)
        if s[0] == 'serve.step':
            assert parent is None
        elif s[0] == 'model.decoder.layer':
            assert parent[0] == 'model.decoder'
        else:
            assert parent is top, (s[0], parent)


@pytest.mark.parametrize('family', ['far3d', 'streampetr'])
def test_a_frame_is_bitwise_the_same_with_the_profiler_on(family):
    step, state, _ = _frame_step(family)
    dets, new = step(state)
    (traced_dets, traced_new), spans = _labels(lambda: step(state))
    assert spans
    for k in dets:
        assert torch.equal(dets[k], traced_dets[k]), k
    for k in vars(new):
        assert torch.equal(getattr(new, k), getattr(traced_new, k)), k


@pytest.mark.parametrize('family', ['far3d', 'streampetr'])
def test_no_profiler_no_record_function(family, monkeypatch):
    step, state, _ = _frame_step(family)

    def entered(*args, **kwargs):
        raise AssertionError('record_function entered with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', entered)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', entered)
    assert not torch.autograd._profiler_enabled()
    dets, _ = step(state)
    assert dets['scores'].shape[0] == 1
    with pytest.raises(AssertionError, match='no profiler'):
        with profile(activities=[ProfilerActivity.CPU]):
            step(state)


TRAIN_LABELS = ('train.inputs', 'train.forward', 'train.loss_3d',
                'train.backward', 'train.optimizer', 'train.grad_all_reduce')


@pytest.mark.parametrize('family', ['far3d', 'streampetr'])
def test_a_training_step_matches_inside_the_3d_loss(family, monkeypatch):
    if family == 'far3d':
        step, (ts, tstate) = train_entry(tiny_test_config(), device='cpu')
        labels = TRAIN_LABELS + ('train.loss_2d',)
    else:
        step, (ts, tstate) = petr_train_entry(tiny_petr_config(),
                                              device='cpu')
        labels = TRAIN_LABELS
    calls = []
    real = losses3d.hungarian_match

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(losses3d, 'hungarian_match', counted)
    _, spans = _labels(lambda: step(ts, tstate))
    counts = collections.Counter(name for name, *_ in spans)
    assert calls and counts['train.match'] == len(calls)
    for name in labels:
        assert counts[name] == 1, name
    by = {s[0]: s for s in spans}
    for s in spans:
        parent = _parent(s, spans)
        if s[0] == 'train.match':
            assert parent[0] == 'train.loss_3d'
        elif s[0] == 'train.grad_all_reduce':
            assert parent[0] == 'train.optimizer'
        elif s[0].startswith('model.'):
            assert _inside(s, by['train.forward']), s[0]
        else:
            assert parent is None, (s[0], parent)
