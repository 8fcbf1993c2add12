"""Small constant tensors kept per device.

A ``torch.tensor(<list>, device=...)`` made inside a frame is a pageable
host-to-device copy each call, which a CUDA graph's capture
(``utils/graphs.py``) refuses; ``constant`` makes each such tensor once.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(values: Sequence[float], dtype: torch.dtype,
             device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made at the
    first call for its values, dtype and device and kept. Callers read it
    and never write to it."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):     # usable where autograd records
            t = torch.tensor(key[0], dtype=dtype, device=device)
        _CONSTANTS[key] = t
    return t
