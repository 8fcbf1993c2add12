"""The streaming step's CUDA graphs (``far3d_tpu_torch/utils/graphs.py``).

On the CPU: when the step runs a frame eagerly (always on the CPU; under a
forward hook or pre-hook, on a module or global; under
``capture_sampling``), what its cache key tells apart, the per-device
constants against the per-call tensors they replace, and the replay's
buffers and counters with the capture stood in for by one that reruns the
captured function into the tensors it first returned (what a graph's replay
writes), bitwise against the eager frames; and ``graph_frames.serve``
(``portbench/metrics``) on a trace laid out by hand and on the labels of
tiny replayed frames.

On the card (``cuda`` marker; skipped without one): both families at full
size, and StreamPETR with the EVA-02 ViT-L backbone at 6 x 800x1600, 40
frames through one graphed step against a fresh eager step each frame,
bitwise. This file imports neither jax nor the JAX package; on a
machine with a card and without jax:

    python -m pytest --noconftest tests/test_torch_port_graphs.py -q
"""

import collections
import math
import pathlib
import sys
import threading
import types

import pytest
import torch
from torch.profiler import record_function

from far3d_tpu_torch.config import IMG_MEAN, IMG_STD, Far3DConfig, \
    tiny_test_config
from far3d_tpu_torch.entry import build_model, build_petr_model
from far3d_tpu_torch.models.decoder import capture_sampling
from far3d_tpu_torch.models.farhead import init_state
from far3d_tpu_torch.models.streampetr import (StreamPETRConfig,
                                               init_petr_state,
                                               tiny_petr_config)
from far3d_tpu_torch.models.streampetr_vit import StreamPETRViTConfig
from far3d_tpu_torch.ops import _build
from far3d_tpu_torch.train.petr_step import make_petr_infer_step
from far3d_tpu_torch.train.step import make_infer_step
from far3d_tpu_torch.utils import constants, graphs
from far3d_tpu_torch.utils.synthetic import (inference_inputs,
                                             petr_inference_inputs)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / 'portbench' / 'tests'))
import pb_tiny  # noqa: E402,F401  (puts portbench's harness on the path)
from harness import spec  # noqa: E402
from harness.trace import Trace, host_span, profiled  # noqa: E402

FAMILIES = ('far3d', 'streampetr')


class Rig:
    """One family's model, step maker, state maker and frame inputs."""

    def __init__(self, family, cfg, device, quant=False):
        self.cfg, self.device = cfg, device
        if family == 'far3d':
            self.model = build_model(cfg, device)
            self.make_step = make_infer_step
            self.fresh_state = lambda: init_state(1, cfg.head, device)
            inputs = inference_inputs(cfg, seed=0)
            self.cams, self.hw = cfg.data.num_cams, cfg.data.input_hw
        else:
            self.model = build_petr_model(cfg, device)
            self.make_step = make_petr_infer_step
            self.fresh_state = lambda: init_petr_state(1, cfg, device)
            inputs = petr_inference_inputs(cfg, 1, seed=0)
            self.cams, self.hw = cfg.num_cams, cfg.input_hw
        self.fixed = {k: torch.from_numpy(v).to(device)
                      for k, v in inputs.items()
                      if k in ('lidar2img', 'intrinsics', 'extrinsics')}
        self.quant = None
        if quant:
            from far3d_tpu_torch.ops import quant as q
            calib = [self.images(s) for s in (101, 102)]
            self.quant = q.quantize_detector_backbone(self.model, calib)
        self.gen = torch.Generator(device=device).manual_seed(0)

    def images(self, seed=None):
        """A (1, N, H, W, 3) uint8 frame, seeded, or the generator's
        next."""
        gen = (torch.Generator(device=self.device).manual_seed(seed)
               if seed is not None else self.gen)
        return torch.randint(0, 256, (1, self.cams, *self.hw, 3),
                             generator=gen, device=self.device,
                             dtype=torch.uint8)

    def batch(self, i, prev_exists=True):
        """Frame i: fresh images, a pose driven 0.7 m a frame along x and
        turned 0.01 rad a frame."""
        a = 0.01 * i
        pose = torch.tensor([[math.cos(a), -math.sin(a), 0., 0.7 * i],
                             [math.sin(a), math.cos(a), 0., 0.],
                             [0., 0., 1., 0.], [0., 0., 0., 1.]])
        return dict(images=self.images(), **self.fixed,
                    timestamp=torch.full((1,), 0.1 * i, device=self.device),
                    prev_exists=torch.full((1,), float(prev_exists),
                                           device=self.device),
                    ego_pose=pose[None].to(self.device),
                    ego_pose_inv=torch.linalg.inv(pose)[None].to(self.device))


def _tiny(family):
    return Rig(family, tiny_test_config() if family == 'far3d'
               else tiny_petr_config(), torch.device('cpu'))


BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _equal(a, b):
    """Bitwise equality of two trees of tensors (dicts, dataclasses)."""
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.is_floating_point():
            a, b = (t.contiguous().view(BITS[t.element_size()])
                    for t in (a, b))
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return all(_equal(x, getattr(b, k)) for k, x in graphs._fields(a))


class CpuCapture:
    """``graphs._Capture`` on the CPU: a replay reruns the captured
    function and copies its outputs into the tensors it returned at
    capture, the tensors a graph's replay writes."""

    def __init__(self, device):
        pass

    def warm_up(self, fn):
        fn()

    def __call__(self, fn):
        out = fn()

        def replay():                     # calls no launch-counting wrapper
            counts = dict(_build.launch_counts)
            graphs._copy(out, fn())
            _build.launch_counts.update(counts)
        return replay, out


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Frames on the CPU captured and replayed by ``CpuCapture``."""
    monkeypatch.setattr(graphs, '_graphable', lambda key: True)
    monkeypatch.setattr(graphs, '_Capture', CpuCapture)


# -- when a frame runs eagerly ------------------------------------------------

@pytest.mark.parametrize('family', FAMILIES)
def test_every_frame_runs_eagerly_on_the_cpu(family):
    rig = _tiny(family)
    step = rig.make_step(rig.cfg)
    state = rig.fresh_state()
    for i in range(3):
        batch = rig.batch(i, prev_exists=i > 0)
        dets, new = step(rig.model, state, batch)
        want = step.eager(rig.model, state, batch, None)
        assert _equal(dets, want[0]) and _equal(new, want[1])
        state = new
    assert (step.eager_frames, step.captures, step.replays) == (3, 0, 0)


def _module_hook(model):
    return model.img_neck.register_forward_hook(lambda m, a, o: None)


def _module_pre_hook(model):
    layer = [m for m in model.modules() if isinstance(m, torch.nn.Linear)][-1]
    return layer.register_forward_pre_hook(lambda m, a: None)


def _global_hook(model):
    return torch.nn.modules.module.register_module_forward_hook(
        lambda m, a, o: None)


def _global_pre_hook(model):
    return torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, a: None)


class _Sampling:
    """``capture_sampling`` as a handle with ``remove``."""

    def __init__(self, model):
        self.ctx = capture_sampling(model)
        self.lists = self.ctx.__enter__()

    def remove(self):
        self.ctx.__exit__(None, None, None)


WATCHERS = {'module_hook': _module_hook, 'module_pre_hook': _module_pre_hook,
            'global_hook': _global_hook, 'global_pre_hook': _global_pre_hook,
            'capture_sampling': _Sampling}


@pytest.mark.parametrize('watcher', sorted(WATCHERS))
def test_a_watched_frame_runs_eagerly(watcher, cpu_graphs):
    rig = _tiny('far3d')
    step = rig.make_step(rig.cfg)
    state = rig.fresh_state()
    for i in range(2):                       # eager, then capture and replay
        _, state = step(rig.model, state, rig.batch(i, i > 0))
    assert (step.eager_frames, step.captures, step.replays) == (1, 1, 1)
    handle = WATCHERS[watcher](rig.model)
    try:
        batch = rig.batch(2)
        dets, new = step(rig.model, state, batch)
        assert (step.eager_frames, step.replays) == (2, 1)
        if watcher == 'capture_sampling':
            assert all(len(calls) == 1 for calls in handle.lists)
    finally:
        handle.remove()
    want = step.eager(rig.model, state, batch, None)
    assert _equal(dets, want[0]) and _equal(new, want[1])
    step(rig.model, new, rig.batch(3))
    assert (step.eager_frames, step.captures, step.replays) == (2, 1, 2)


# -- the cache key ----------------------------------------------------------

def _key_case(change, rig, state, batch):
    """(state, batch, quant_tree) of `change` from a frame's."""
    batch, quant = dict(batch), None
    if change == 'image_shape':
        batch['images'] = batch['images'][:, :, :-8]
    elif change == 'image_dtype':
        batch['images'] = batch['images'].to(torch.bfloat16)
    elif change == 'pose_dtype':
        batch['ego_pose'] = batch['ego_pose'].double()
    elif change == 'state_shape':
        state = graphs._clone(state)
        state.embedding = state.embedding[:, :-1]
    elif change == 'quant_tree':
        quant = {}
    return state, batch, quant


@pytest.mark.parametrize('change', ['image_shape', 'image_dtype',
                                    'pose_dtype', 'state_shape',
                                    'quant_tree', 'values'])
def test_the_cache_key_tells_apart_shapes_dtypes_and_trees(change):
    rig = _tiny('far3d')
    state, batch = rig.fresh_state(), rig.batch(0)
    key = graphs.frame_key(rig.model, state, batch)
    assert graphs.frame_key(rig.model, state, dict(batch)) == key
    if change == 'values':                  # new values, the same key
        assert graphs.frame_key(rig.model, rig.fresh_state(),
                                rig.batch(5)) == key
        return
    s, b, q = _key_case(change, rig, state, batch)
    assert graphs.frame_key(rig.model, s, b, q) != key
    if change == 'quant_tree':               # another tree, another key
        assert graphs.frame_key(rig.model, s, b, {}) != \
            graphs.frame_key(rig.model, s, b, q)


def test_the_key_is_graphable_only_on_one_card():
    rig = _tiny('far3d')
    key = graphs.frame_key(rig.model, rig.fresh_state(), rig.batch(0))
    assert not graphs._graphable(key)
    on_card = (key[0], key[1], tuple((n, torch.device('cuda', 0), d, s)
                                     for n, _, d, s in key[2]))
    assert graphs._graphable(on_card)
    mixed = (key[0], key[1], on_card[2][:-1] + key[2][-1:])
    assert not graphs._graphable(mixed)


# -- per-device constants ---------------------------------------------------

# each site's constant: (values, the dtype its per-call torch.tensor was
# given, None for the default, the dtype it now passes to constant)
_F32, _BF16 = torch.float32, torch.bfloat16
CONSTANTS = {
    'detector_img_mean': (Far3DConfig().data.img_mean, None, _F32),
    'detector_img_std': (Far3DConfig().data.img_std, None, _F32),
    'streampetr_img_mean': (IMG_MEAN, None, _F32),
    'streampetr_img_std': (IMG_STD, None, _F32),
    'decode_post_center_range': (Far3DConfig().head.post_center_range, _F32,
                                 _F32),
    'decoder_pad_wh': ((960, 640), _F32, _F32),
    'geometry_pc_range_lo': (Far3DConfig().pc_range[:3], _F32, _F32),
    'geometry_pc_range_hi_bf16': (Far3DConfig().pc_range[3:6], _BF16, _BF16),
    'petr_position_range_lo': (StreamPETRConfig().position_range[:3], _F32,
                               _F32),
    'petr_position_range_hi': (StreamPETRConfig().position_range[3:6], _F32,
                               _F32),
}


@pytest.mark.parametrize('name', sorted(CONSTANTS))
def test_a_constant_equals_the_per_call_tensor(name):
    values, old_dtype, dtype = CONSTANTS[name]
    old = torch.tensor(values, dtype=old_dtype, device='cpu')
    with torch.inference_mode():
        new = constants.constant(values, dtype, torch.device('cpu'))
    assert new.dtype == old.dtype and new.device == old.device
    assert torch.equal(new, old)
    assert not new.is_inference()           # usable where autograd records
    assert constants.constant(list(values), dtype, 'cpu') is new


@pytest.mark.parametrize('family', FAMILIES)
def test_a_second_frame_makes_no_tensor_from_host_values(family,
                                                         monkeypatch):
    """After a first frame, a frame calls ``torch.tensor`` with no device:
    each constant it needs on its device is kept (on a card, a
    ``torch.tensor(list, device=...)`` is a host-to-device copy, which a
    capture refuses)."""
    rig = _tiny(family)
    step = rig.make_step(rig.cfg)
    _, state = step(rig.model, rig.fresh_state(), rig.batch(0, False))
    made = []
    real = torch.tensor

    def tensor(*args, **kwargs):
        if kwargs.get('device') is not None:
            made.append(args[0])
        return real(*args, **kwargs)

    batch = rig.batch(1)
    monkeypatch.setattr(torch, 'tensor', tensor)
    step(rig.model, state, batch)
    assert made == []


# -- replays on the CPU -------------------------------------------------------

@pytest.mark.parametrize('family', FAMILIES)
def test_replayed_frames_are_bitwise_the_eager_ones(family, cpu_graphs,
                                                    monkeypatch):
    """Nine frames, a scene change at frame 5 and a hooked frame at 3,
    through one step against a fresh eager step each frame, each side
    carrying its own state: detections and states bitwise equal; a state
    returned at frame k is unchanged after frame k + 3; one capture; a
    launch-counting wrapper counts the eager frames, the warm-up and the
    capture and no replay, and the step keeps what the capture counted."""
    rig = _tiny(family)
    step = rig.make_step(rig.cfg)
    monkeypatch.setitem(_build.launch_counts, 'graph_test_kernel', 0)
    frame = step.frame

    def counted_frame(*args):
        _build.launch_counts['graph_test_kernel'] += 1
        return frame(*args)

    step.frame = counted_frame
    g_state = e_state = rig.fresh_state()
    kept = collections.deque()
    for i in range(9):
        batch = rig.batch(i, prev_exists=i not in (0, 5))
        hook = _module_hook(rig.model) if i == 3 else None
        before = _build.launch_counts['graph_test_kernel']
        try:
            dets, g_state = step(rig.model, g_state, batch)
        finally:
            if hook is not None:
                hook.remove()
        # frame 1 warms up and captures, then replays
        assert _build.launch_counts['graph_test_kernel'] - before == (
            {0: 1, 3: 1, 1: 2}.get(i, 0)), i
        e_dets, e_state = rig.make_step(rig.cfg)(rig.model, e_state, batch)
        assert _equal(dets, e_dets) and _equal(g_state, e_state), i
        kept.append((i, g_state, graphs._clone(g_state)))
        while kept and kept[0][0] <= i - 3:
            k, held, copy = kept.popleft()
            assert _equal(held, copy), k
    assert (step.captures, step.eager_frames, step.replays) == (1, 2, 7)
    assert list(step.capture_launches.values()) == [
        {'graph_test_kernel': 1}]


@pytest.mark.parametrize('family', FAMILIES)
def test_a_replayed_frame_runs_its_graphs_inside_serve_replay(family,
                                                              cpu_graphs):
    rig = _tiny(family)
    step = rig.make_step(rig.cfg)
    state = rig.fresh_state()
    for i in range(2):
        _, state = step(rig.model, state, rig.batch(i, i > 0))

    def frames():
        nonlocal state
        with record_function('bench.window'):
            for i in (2, 3):
                with record_function('bench.frame'):
                    _, state = step(rig.model, state, rig.batch(i))

    _, events = profiled(frames)
    t = Trace(events, host_span(events, 'bench.window'))
    replay = t.labels['serve.replay']
    assert len(replay) == 2 and len(t.labels['serve.step']) == 2
    for outer, inner in (('serve.step', 'serve.replay'),
                         ('serve.replay', 'model.backbone'),
                         ('serve.replay', 'model.queries')):
        for s, e in t.labels[inner]:
            assert any(a <= s and e <= b for a, b in t.labels[outer]), inner
    read = spec.metric_reader('graph_frames.serve')
    ctx = _ctx(t, frames=2)
    assert read(ctx) == 100.0


def test_a_capture_runs_inside_serve_capture(cpu_graphs):
    """The frame that captures its key warms it up and captures it inside
    one ``serve.capture`` label of its ``serve.step``, then replays."""
    rig = _tiny('far3d')
    step = rig.make_step(rig.cfg)
    state = rig.fresh_state()

    def frames():
        nonlocal state
        with record_function('bench.window'):
            for i in range(3):
                _, state = step(rig.model, state, rig.batch(i, i > 0))

    _, events = profiled(frames)
    t = Trace(events, host_span(events, 'bench.window'))
    (capture,) = t.labels['serve.capture']
    steps = t.labels['serve.step']
    assert len(steps) == 3 and steps[1][0] <= capture[0] <= capture[1] \
        <= steps[1][1]
    (replay, _) = t.labels['serve.replay']
    assert capture[1] <= replay[0] <= steps[1][1]
    def towers_in(lo, hi):
        return len([s for s, _ in t.labels['model.backbone'] if lo <= s <= hi])

    # the warm-up's towers and the capture's, each as an eager frame's
    assert towers_in(*capture) == 2 * towers_in(*steps[0]) > 0


# -- graph_frames.serve -----------------------------------------------------

def _ctx(trace, frames):
    return types.SimpleNamespace(traced=dict(trace=trace, frames=frames),
                                 e2e={'frame_ms': 1.0})


def _trace(labels):
    t = Trace([], (0, 1000))
    t.labels = {k: sorted(v) for k, v in labels.items()}
    t._starts = {k: [s for s, _ in v] for k, v in t.labels.items()}
    return t


@pytest.mark.parametrize('replays,frames,want', [(4, 4, 100.0),
                                                 (3, 4, 75.0),
                                                 (0, 4, None)])
def test_graph_frames_reads_the_share_of_replayed_frames(replays, frames,
                                                         want):
    labels = {'bench.window': [(0, 1000)],
              'serve.step': [(100 * i, 100 * i + 90) for i in range(frames)]}
    if replays:
        labels['serve.replay'] = [(100 * i + 10, 100 * i + 80)
                                  for i in range(replays)]
    read = spec.metric_reader('graph_frames.serve')
    assert read(_ctx(_trace(labels), frames)) == want


def test_graph_frames_reads_nothing_on_eager_frames():
    """A tiny frame on the CPU runs eagerly: the program's labels reach the
    trace and ``serve.replay`` is not among them."""
    rig = _tiny('far3d')
    step = rig.make_step(rig.cfg)
    state = rig.fresh_state()

    def frames():
        with record_function('bench.window'):
            step(rig.model, state, rig.batch(0, False))

    _, events = profiled(frames)
    t = Trace(events, host_span(events, 'bench.window'))
    assert t.labels.get('serve.step') and 'serve.replay' not in t.labels
    assert spec.metric_reader('graph_frames.serve')(_ctx(t, 1)) is None


# -- the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


FRAMES, SCENES, HOOKED = 40, (0, 14, 29), (9, 23)


@pytest.mark.cuda
@pytest.mark.parametrize('family', FAMILIES + ('streampetr_vit',))
def test_graphed_frames_are_bitwise_the_eager_ones_on_the_card(family,
                                                                cuda_device):
    """Full size (Far3D with its int8 backbone, StreamPETR in bf16, and
    StreamPETR with the ViT-L backbone in bf16, one ``swiglu_tail`` and
    one ``vit_rope`` launch a block):
    FRAMES frames with scene changes at SCENES and a hooked frame at each
    of HOOKED through one graphed step, against a fresh eager step each
    frame, each side carrying its own state: detections and every state
    tensor bitwise equal frame by frame, a state returned at frame k
    unchanged after frame k + 3, one capture. The launch-counting wrappers
    count each eager frame's port kernels alike, twice that in the frame
    that warms up and captures, none in a replay, and the capture keeps
    its count; a profiler's trace of a replayed frame shows those kernels
    run on the card, each launched by a ``cudaGraphLaunch``."""
    if family == 'far3d':
        rig = Rig(family, Far3DConfig(), cuda_device, quant=True)
    elif family == 'streampetr_vit':
        rig = Rig('streampetr', StreamPETRViTConfig(), cuda_device)
    else:
        rig = Rig(family, StreamPETRConfig(), cuda_device)
    step = rig.make_step(rig.cfg)
    g_state = e_state = rig.fresh_state()
    kept, launches = collections.deque(), []
    for i in range(FRAMES):
        batch = rig.batch(i, prev_exists=i not in SCENES)
        hook = _module_hook(rig.model) if i in HOOKED else None
        before = dict(_build.launch_counts)
        try:
            dets, g_state = step(rig.model, g_state, batch, rig.quant)
        finally:
            if hook is not None:
                hook.remove()
        launches.append({k: v - before.get(k, 0)
                         for k, v in _build.launch_counts.items()
                         if v != before.get(k, 0)})
        e_dets, e_state = rig.make_step(rig.cfg)(rig.model, e_state, batch,
                                                 rig.quant)
        for k in dets:
            assert _equal(dets[k], e_dets[k]), (i, k)
        for k, t in graphs._fields(g_state):
            assert _equal(t, getattr(e_state, k)), (i, k)
        kept.append((i, g_state, graphs._clone(g_state)))
        while kept and kept[0][0] <= i - 3:
            k, held, copy = kept.popleft()
            assert _equal(held, copy), k
    assert (step.captures, step.eager_frames, step.replays) == (
        1, 1 + len(HOOKED), FRAMES - 1 - len(HOOKED))
    per_frame = launches[0]
    assert all(launches[i] == per_frame for i in HOOKED), launches
    assert launches[1] == {k: 2 * n for k, n in per_frame.items()}
    assert not any(launches[i] for i in range(2, FRAMES)
                   if i not in HOOKED), launches
    assert list(step.capture_launches.values()) == [per_frame]
    if family == 'far3d':
        assert per_frame['msda_fwd'] == rig.cfg.decoder.num_layers
    if family == 'streampetr_vit':
        depth = rig.cfg.backbone.depth
        assert per_frame == {'swiglu_tail': depth, 'vit_rope': depth}
    batch = rig.batch(FRAMES)
    run, replayed = _port_kernels(
        lambda: step(rig.model, g_state, batch, rig.quant), per_frame)
    assert run == replayed == per_frame, (run, replayed)


def _port_kernels(fn, names):
    """Runs `fn` under the profiler; for each of `names` (launch-counter
    names, each the prefix of its kernel's ``<name>_kernel``) the kernels
    that ran on the card, and how many of them a ``cudaGraphLaunch``
    launched."""
    torch.cuda.synchronize()
    _, events = profiled(lambda: (fn(), torch.cuda.synchronize()))
    graph = {e.correlation_id() for e in events
             if e.name().startswith('cudaGraphLaunch')}
    run, replayed = {}, {}
    for e in events:
        if 'CUDA' not in str(e.device_type()).upper():
            continue
        for name in names:
            if f'{name}_kernel' in e.name():
                run[name] = run.get(name, 0) + 1
                if e.correlation_id() in graph:
                    replayed[name] = replayed.get(name, 0) + 1
    return run, replayed


@pytest.mark.cuda
@pytest.mark.parametrize('family', FAMILIES)
def test_a_capture_beside_a_thread_that_pins_memory(family, cuda_device):
    """A loader's worker threads pin host memory (``cudaHostAlloc``) while
    the step captures a frame, as in an eval inside a training loop: the
    capture goes through, and the replays match eager frames bitwise."""
    cfg = tiny_test_config() if family == 'far3d' else tiny_petr_config()
    rig = Rig(family, cfg, cuda_device)
    step = rig.make_step(rig.cfg)
    stop, pinned = threading.Event(), []

    def pin():
        while not stop.is_set() and len(pinned) < 4096:
            pinned.append(torch.empty(1 << 16, dtype=torch.uint8,
                                      pin_memory=True))

    worker = threading.Thread(target=pin, daemon=True)
    try:
        g_state = e_state = rig.fresh_state()
        for i in range(4):
            batch = rig.batch(i, prev_exists=i > 0)
            if i == 1:                          # pinning through the capture
                worker.start()
            dets, g_state = step(rig.model, g_state, batch)
            e_dets, e_state = rig.make_step(rig.cfg)(rig.model, e_state,
                                                     batch)
            assert _equal(dets, e_dets) and _equal(g_state, e_state), i
    finally:
        stop.set()
        if worker.is_alive():
            worker.join(timeout=60)
    assert not worker.is_alive() and pinned
    assert (step.captures, step.replays) == (1, 3)

