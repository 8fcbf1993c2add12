"""GridMask augmentation (counterpart of ``far3d_tpu/ops/grid_mask.py``;
reference models/utils/grid_mask.py with mode=1 and no rotation).

Split in two so that a test can hand in the JAX package's draws: ``draw``
takes the four random numbers from a ``torch.Generator``; ``apply`` is a
deterministic function of them. With mode=1 the kept pixels are the union of
horizontal and vertical stripes of width l = clip(int(d * ratio + 0.5), 1,
d - 1), period d, phases st_h and st_w; one mask is shared by the whole
batch and applied with probability `prob`.
"""

from __future__ import annotations

from typing import Dict

import torch


def draw(h: int, prob: float, generator: torch.Generator) -> Dict[str, int]:
    """The draws of grid_mask.py:20-25: apply ~ U[0,1) < prob,
    d ~ U{2..h-1}, st_h, st_w ~ U{0..d-1}."""
    dev = generator.device
    apply = bool(torch.rand((), generator=generator, device=dev) < prob)
    d = int(torch.randint(2, h, (), generator=generator, device=dev))
    st_h = int(torch.randint(0, d, (), generator=generator, device=dev))
    st_w = int(torch.randint(0, d, (), generator=generator, device=dev))
    return dict(apply=apply, d=d, st_h=st_h, st_w=st_w)


def apply(images: torch.Tensor, apply: bool, d: int, st_h: int, st_w: int,
          ratio: float = 0.5) -> torch.Tensor:
    """images (..., H, W, C) -> masked images (grid_mask.py:23-34)."""
    if not apply:
        return images
    h, w = images.shape[-3], images.shape[-2]
    length = min(max(int(d * ratio + 0.5), 1), d - 1)
    rows = torch.arange(h, device=images.device)
    cols = torch.arange(w, device=images.device)
    keep = (((rows - st_h) % d) < length)[:, None] | \
        (((cols - st_w) % d) < length)[None, :]
    return images * keep.to(images.dtype)[..., None]
