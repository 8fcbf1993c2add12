"""The run's check that nothing of JAX, nor the JAX package, was loaded in
the process: each module's top-level name (before the first dot) compared
whole, so ``far3d_tpu_torch`` is not taken for ``far3d_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'far3d_tpu')


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split('.')[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN)
