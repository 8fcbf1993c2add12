"""What the host was like around a measured window, printed on standard
error beside the run's numbers, so that a run that reads slow can be laid
beside the host's own speed: the CPU the process ran on and five timings
of a fixed Python loop, before the window and after it. (The sandbox the
card's machine runs reports no steal time, load or context switches.)"""

from __future__ import annotations

import ctypes
import sys
import time
from typing import Dict, List

_LOOP = 200_000


def _cpu() -> int:
    try:
        return int(ctypes.CDLL(None).sched_getcpu())
    except (OSError, AttributeError):
        return -1


def loop_ms(n: int = 5) -> List[float]:
    """`n` timings of a fixed pure-Python loop, in ms."""
    out = []
    for _ in range(n):
        a = time.perf_counter()
        x = 0
        for k in range(_LOOP):
            x += k & 7
        out.append((time.perf_counter() - a) * 1e3)
    return out


def snapshot() -> Dict:
    return dict(cpu=_cpu(), loop_ms=loop_ms())


def report(before: Dict, after: Dict) -> Dict:
    """Prints and returns the host's facts around a window."""
    facts = dict(cpu_before=before['cpu'], cpu_after=after['cpu'],
                 loop_ms_before=before['loop_ms'],
                 loop_ms_after=after['loop_ms'])
    print(f'host: {facts}', file=sys.stderr)
    return facts
