"""One process, no group: the reference runs the single-card step. The
port's data-parallel reductions become what they are at world size 1."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def group():
    return None


def rank_and_world() -> Tuple[int, int]:
    return 0, 1


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    return None


def normalizer(n: torch.Tensor) -> torch.Tensor:
    """max(n, 1)."""
    return n.clamp(min=1.0)


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return metrics


def shard_batch(tree: Any, rank: int, world: int) -> Any:
    return tree
