"""The ViT backbone's 2D rotary embedding of q and k (the port's
``models/vit.py:rope``, between the ``qkv`` matmul and the attention): the
bytes it must move, counted from the configuration's shapes, and its least
time.

Per block, over the tokens the block's attention call takes: the padded map
in a windowed block (the grid zero-padded at the bottom and right to
multiples of ``window_size``), the real grid in a global one. Each token's
q and k, ``2 x embed_dim`` channels, are read once and written once, in
bf16; the cos and sin tables (at most a grid's tokens x head width, kept in
the caches) are left out. Bound by bytes: the least time is the bytes at
the HBM bandwidth (``work.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

from . import work

BF16_BYTES = 2


def block_tokens(vit: Dict, num_cams: int, input_hw: Sequence[int],
                 block: int) -> int:
    """Tokens of block `block`'s attention call for the rig's frame."""
    p, ws = vit['patch_size'], vit['window_size']
    rows, cols = input_hw[0] // p, input_hw[1] // p
    if block not in vit['global_blocks']:
        rows, cols = rows + -rows % ws, cols + -cols % ws
    return num_cams * rows * cols


def block_bytes(vit: Dict, num_cams: int, input_hw: Sequence[int],
                block: int) -> int:
    """Bytes block `block`'s rotation must move for the rig's frame."""
    return (block_tokens(vit, num_cams, input_hw, block)
            * 2 * vit['embed_dim'] * 2 * BF16_BYTES)


def frame_bytes(vit: Dict, num_cams: int, input_hw: Sequence[int]) -> int:
    """Bytes of one frame's rotations, one a block."""
    return sum(block_bytes(vit, num_cams, input_hw, i)
               for i in range(vit['depth']))


def least_seconds(vit: Dict, num_cams: int, input_hw: Sequence[int]
                  ) -> float:
    return work.bound_seconds(frame_bytes(vit, num_cams, input_hw), 0, 1.0)
