"""Reduces a ``torch.profiler`` trace of the traced window to what the
per-layer metrics read: the device's busy time (the union of the intervals
in which a kernel, a copy or a memset ran), kernel time and launches by
name, the device time of the kernels launched inside a host label
(``record_function``) of the program or of the benchmark, the labels' host
spans, and the longest idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_KINDS = ('kernel', 'memcpy', 'memset')


class Trace:
    """The events of one traced window. Times are in ns on the profiler's
    clock; `window` is (start, end) of the benchmark's traced window."""

    def __init__(self, events: Iterable, window: Tuple[int, int]):
        self.window = window
        self.ops: List[Tuple[int, int, str, str, int]] = []   # device ops
        self.launch_at: Dict[int, int] = {}      # correlation -> host start
        labels = collections.defaultdict(list)
        device = []
        for e in events:
            start, dur = _ns(e)
            if _on_device(e):
                device.append((start, start + dur, e.name(),
                               e.correlation_id(), _annotation(e)))
            elif RUNTIME.match(e.name()):
                self.launch_at[e.correlation_id()] = start
            elif _annotation(e):
                labels[e.name()].append((start, start + dur))
        for s, e, name, corr, note in device:
            if note or name in labels:      # a label's device-side copy
                continue
            self.ops.append((s, e, name, _device_kind(name), corr))
        self.ops.sort()
        self.labels = {k: sorted(v) for k, v in labels.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.labels.items()}

    # -- the device ---------------------------------------------------------

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device ops' intervals, clipped to the window."""
        lo, hi = self.window
        merged: List[List[int]] = []
        for s, e, *_ in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> List[Tuple[int, int, str, str, int]]:
        return [op for op in self.ops if op[3] == 'kernel']

    def launches(self) -> int:
        return len(self.kernels())

    def kernel_seconds(self, names: Sequence[str]) -> Tuple[float, int]:
        """Summed device time and count of the kernels whose demangled name
        contains one of `names` (a kernel table's entries)."""
        total, count = 0, 0
        for s, e, name, _, _ in self.kernels():
            if any(n in name for n in names):
                total += e - s
                count += 1
        return total / 1e9, count

    def seconds_between(self, first: str, last: str) -> Tuple[float, int]:
        """Summed device time and count of the kernels that run after a
        kernel whose name contains `first` and before the next one whose
        name contains `last` (the two left out)."""
        total, count, inside = 0, 0, False
        for s, e, name, _, _ in self.kernels():
            if first in name:
                inside = True
            elif last in name:
                inside = False
            elif inside:
                total += e - s
                count += 1
        return total / 1e9, count

    def under_label(self, label: str) -> Optional[float]:
        """Device seconds of the ops launched while the host was inside
        `label` (on any thread); None where the label never ran."""
        spans = self.labels.get(label)
        if not spans:
            return None
        starts = self._starts[label]
        total = 0
        for s, e, _, _, corr in self.ops:
            at = self.launch_at.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += e - s
        return total / 1e9

    def label_seconds(self, label: str) -> Optional[float]:
        """The host's summed wall time inside `label`; None where it never
        ran."""
        spans = self.labels.get(label)
        return None if not spans else sum(e - s for s, e in spans) / 1e9

    # -- what the breakdown shows ---------------------------------------------

    def top_ops(self, n: int = 10) -> List[List]:
        by = collections.Counter()
        for s, e, name, _, _ in self.ops:
            by[name[:120]] += e - s
        return [[k, v / 1e9] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10, skip: Sequence[str] = ()) -> List[List]:
        """The device's idle time in the window, summed by the innermost
        host label open at each gap's middle (labels in `skip`, such as the
        benchmark's frame label, only where nothing finer is open)."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        by = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                by[self._label_at((a + b) // 2, skip)] += b - a
        return [[k, v / 1e9] for k, v in by.most_common(n)]

    def _label_at(self, t: int, skip: Sequence[str]) -> str:
        best, best_len, fallback = None, None, None
        for name, spans in self.labels.items():
            i = bisect.bisect_right(self._starts[name], t) - 1
            if i >= 0 and t <= spans[i][1]:
                if name in skip:
                    fallback = name
                    continue
                length = spans[i][1] - spans[i][0]
                if best_len is None or length < best_len:
                    best, best_len = name, length
        return best or fallback or 'outside any label'


# host calls into the CUDA runtime or driver (cudaLaunchKernel,
# cuLaunchKernelEx, cudaMemcpyAsync, cudaGraphLaunch, ...)
RUNTIME = re.compile(r'^cu[A-Z]|^cuda[A-Z]')


def _ns(e) -> Tuple[int, int]:
    """(start, duration) of a kineto event in ns."""
    if hasattr(e, 'start_ns'):
        return e.start_ns(), e.duration_ns()
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def _on_device(e) -> bool:
    return 'CUDA' in str(e.device_type()).upper()


def _annotation(e) -> bool:
    return bool(getattr(e, 'is_user_annotation', lambda: False)())


def _device_kind(name: str) -> str:
    """'memcpy', 'memset' or 'kernel', by the name CUPTI gives the op."""
    low = name.lower()
    if low.startswith('memcpy'):
        return 'memcpy'
    if low.startswith('memset'):
        return 'memset'
    return 'kernel'


def host_span(events, name: str) -> Tuple[int, int]:
    """(start, end) in ns of the first host label `name`."""
    for e in events:
        if e.name() == name and _annotation(e) and not _on_device(e):
            start, dur = _ns(e)
            return start, start + dur
    raise ValueError(f'no host label {name!r} in the trace')


def profiled(fn):
    """Run `fn()` under ``torch.profiler`` (host and device) and return
    (fn's result, the profiler's kineto events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()
