"""The ViT backbone's SwiGLU tail (the port's ``models/vit.py:swiglu_tail``,
between the ``w12`` and ``w3`` matmuls): the bytes it must move, counted
from the configuration's shapes, and its least time.

Per block, over every token of the rig (the MLP runs on the unpadded map):
read the SiLU input and the gate, ``mlp_hidden_dim`` channels each, and
write ``w3``'s input, the hidden width padded to a multiple of 8, all in
bf16. Bound by bytes: the least time is the bytes at the HBM bandwidth
(``work.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

from . import work

BF16_BYTES = 2


def block_bytes(vit: Dict, num_cams: int, input_hw: Sequence[int]) -> int:
    """Bytes one block's tail must move for the rig's frame."""
    p = vit['patch_size']
    tokens = num_cams * (input_hw[0] // p) * (input_hw[1] // p)
    hid = vit['mlp_hidden_dim']
    return tokens * (2 * hid + hid + -hid % 8) * BF16_BYTES


def frame_bytes(vit: Dict, num_cams: int, input_hw: Sequence[int]) -> int:
    """Bytes of one frame's tails, one a block."""
    return vit['depth'] * block_bytes(vit, num_cams, input_hw)


def least_seconds(vit: Dict, num_cams: int, input_hw: Sequence[int]
                  ) -> float:
    return work.bound_seconds(frame_bytes(vit, num_cams, input_hw), 0, 1.0)
