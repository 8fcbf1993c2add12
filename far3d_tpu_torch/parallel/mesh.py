"""Data parallelism across processes and cards over ``torch.distributed``
(counterpart of ``far3d_tpu/parallel/mesh.py``; reference: torch DDP,
core/apis/mmdet_train.py:79-83, and its NCCL launchers).

The JAX package has one ``data`` mesh axis: parameters replicated, the batch
and the per-lane temporal state sharded, the gradient all-reduce inserted by
XLA. Here one process drives one card and holds its contiguous lanes of the
global batch (``shard_batch``); the parameters start equal on every rank
(``broadcast_``) and stay equal because every rank applies the same averaged
gradient. What couples the lanes under the JAX mesh is made explicit where
the training code needs it: the YOLOX BatchNorm statistics
(``models/layers.py``, through the differentiable ``all_reduce_sum``), the
loss normalizers (``normalizer``), the gradients (``all_reduce_mean_``, in
flat buckets) and the logged losses (``mean_over_ranks``). The temporal state never leaves its rank: the
streaming sampler pins one scene stream per lane.

With no process group every helper is the identity, so one process runs
exactly the code it runs without this module. The group is
``torch.distributed``'s default one, set up by ``init_distributed``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from datetime import timedelta
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a rank that never arrives fails the others' collectives after this long:
# long enough for rank 0 to score a whole validation set while the others
# wait at their next step
DEFAULT_TIMEOUT = timedelta(minutes=30)
BUCKET_BYTES = 64 << 20          # gradients all-reduced 64 MiB at a time


def group():
    """The run's process group, or None when the process runs alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a group."""
    if group() is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    """Whether this process is rank 0 (or alone): the one that writes."""
    return rank_and_world()[0] == 0


def barrier() -> None:
    """Wait for every rank; nothing without a group."""
    if group() is None:
        return
    if dist.get_backend() == 'nccl':
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if group() is not None:
        dist.destroy_process_group()


def _device_for(x: torch.Tensor) -> torch.Tensor:
    """NCCL reduces CUDA tensors only; gloo takes CPU and CUDA tensors."""
    if dist.get_backend() == 'nccl' and x.device.type != 'cuda':
        return x.cuda()
    return x


def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ranks, in place; returns it. Without a group, `x`."""
    if group() is not None:
        y = _device_for(x)
        dist.all_reduce(y)
        if y is not x:
            x.copy_(y)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks in the forward; the backward sums the ranks' output
    gradients, which is the gradient of the sum of every rank's loss with
    respect to this rank's input."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks; `x` itself without a group."""
    return x if group() is None else _AllReduceSum.apply(x)


def normalizer(n: torch.Tensor) -> torch.Tensor:
    """A loss normalizer of the global batch from this rank's count `n`:
    max(sum of n over the ranks, 1) / world size, no gradient. A rank's
    loss sum over it has, averaged over the ranks, the JAX step's value on
    the global batch, sum / max(count, 1) (losses3d.py:76,85,111). The
    reference's ``reduce_mean`` (farhead.py:1027-1037) clamps the mean
    instead, which differs when the global count is below the world size.
    Without a group: max(n, 1)."""
    if group() is None:
        return n.clamp(min=1.0)
    total = all_reduce_sum_(n.detach().clone())
    return total.clamp(min=1.0) / dist.get_world_size()


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over the ranks, in one all-reduce; `values`
    without a group."""
    if group() is None or not values:
        return values
    keys = sorted(values)
    stacked = all_reduce_sum_(torch.stack([values[k].detach().float()
                                           for k in keys]))
    stacked /= dist.get_world_size()
    return dict(zip(keys, stacked.unbind()))


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of one dtype and device, each at most BUCKET_BYTES
    (or one tensor)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        last = out[-1] if out else None
        if (last is None or size + nbytes > BUCKET_BYTES
                or t.dtype != last[0].dtype
                or t.device != last[0].device):
            out.append([t])
            size = nbytes
        else:
            last.append(t)
            size += nbytes
    return out


def _bucketed(tensors: Sequence[torch.Tensor], collective) -> int:
    """Run `collective(flat)` on each bucket's flat copy and copy the result
    back into the tensors; returns the bytes communicated."""
    nbytes = 0
    for bucket in _buckets(tensors):
        flat = _device_for(torch.cat([t.reshape(-1) for t in bucket]))
        collective(flat)
        nbytes += flat.numel() * flat.element_size()
        offset = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return nbytes


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> int:
    """Average the tensors (the gradients) over the ranks in place, a flat
    bucket at a time: SUM, then divide by the world size (gloo has no AVG).
    Every rank must pass the same tensors in the same order. Returns the
    bytes all-reduced; 0 without a group."""
    if group() is None:
        return 0
    world = dist.get_world_size()

    def reduce(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    return _bucketed(list(tensors), reduce)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> int:
    """Overwrite the tensors with rank `src`'s, in place; returns the bytes
    sent; 0 without a group."""
    if group() is None:
        return 0
    return _bucketed(list(tensors), lambda f: dist.broadcast(f, src))


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> int:
    """Give every rank rank `src`'s parameters and buffers (the YOLOX BN
    statistics, the frozen points), so that the ranks start equal."""
    with torch.no_grad():
        return broadcast_(list(module.state_dict().values()), src)


def shard_batch(tree: Any, rank: int, world_size: int) -> Any:
    """Rank `rank`'s contiguous lanes of a global batch (twin of
    ``mesh.py:39-43``): the leading axis of every tensor and array in a
    dict, list, tuple or dataclass cut into `world_size` equal parts; other
    leaves (a grid-mask draw's ints) pass unchanged."""
    if world_size == 1:
        return tree

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: cut(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim:
            if x.shape[0] % world_size:
                raise ValueError(f'a batch of {x.shape[0]} lanes does not '
                                 f'split over {world_size} ranks')
            k = x.shape[0] // world_size
            return x[rank * k:(rank + 1) * k]
        return x

    return cut(tree)


def _slurm_first_host(env) -> str:
    """The first host of the Slurm job (mmcv's ``_init_dist_slurm``)."""
    nodes = env.get('SLURM_STEP_NODELIST') or env['SLURM_JOB_NODELIST']
    out = subprocess.run(['scontrol', 'show', 'hostnames', nodes],
                         capture_output=True, text=True, check=True)
    return out.stdout.split()[0]


def _launch(env) -> Optional[Tuple[str, int, int, int]]:
    """(init method, rank, world size, local rank) of the launch, or None
    for a single process."""
    if 'FAR3D_COORDINATOR' in env:
        coord = env['FAR3D_COORDINATOR']
        rank = int(env['FAR3D_PROCESS_ID'])
        return (coord if '://' in coord else f'tcp://{coord}', rank,
                int(env['FAR3D_NUM_PROCESSES']), int(env.get('LOCAL_RANK', 0)))
    if 'RANK' in env and 'WORLD_SIZE' in env:        # torchrun
        return ('env://', int(env['RANK']), int(env['WORLD_SIZE']),
                int(env.get('LOCAL_RANK', 0)))
    if int(env.get('SLURM_NTASKS', '1')) > 1:
        addr = env.get('MASTER_ADDR') or _slurm_first_host(env)
        return (f'tcp://{addr}:{env.get("MASTER_PORT", "29500")}',
                int(env['SLURM_PROCID']), int(env['SLURM_NTASKS']),
                int(env.get('SLURM_LOCALID', 0)))
    return None


def init_distributed(device=None, backend: Optional[str] = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> Tuple[int, int]:
    """Join the run's process group (replaces torch.distributed.launch and
    the Slurm plumbing of the reference, tools/train.py:74-78). Returns
    (rank, world size).

    Three launch paths, in the JAX package's order (``mesh.py:46-70``):
      1. ``FAR3D_COORDINATOR`` (host:port, or an init URL such as
         ``file:///shared/rendezvous``), ``FAR3D_NUM_PROCESSES`` and
         ``FAR3D_PROCESS_ID``, set by ``cli/dist_{train,test}.sh``;
      2. a cluster's environment: torchrun's ``RANK``, ``WORLD_SIZE``,
         ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, or Slurm's
         ``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_LOCALID`` when
         ``SLURM_NTASKS > 1`` (the address from ``MASTER_ADDR`` or the job's
         first host, the port from ``MASTER_PORT`` or 29500);
      3. otherwise no group: (0, 1).

    `device` is the card by default ('cpu' runs the ranks on the CPU); the
    backend is NCCL for a card and gloo for the CPU unless `backend` says
    otherwise, which is the one way to put two ranks on one card (gloo
    takes CUDA tensors; NCCL refuses two ranks on one card). A card is
    required unless `device` is 'cpu', and NCCL always requires one. Each
    rank's card is ``cuda:(local rank % device count)``, made the current
    device. A rank missing from a collective fails it after `timeout`."""
    dev = torch.device('cuda' if device is None else device)
    if (dev.type == 'cuda' or backend == 'nccl') \
            and not torch.cuda.is_available():
        raise RuntimeError('init_distributed: no CUDA device is available; '
                           "pass device='cpu' to run the ranks on the CPU "
                           'over gloo')
    if group() is not None:
        return rank_and_world()
    launch = _launch(os.environ)
    if launch is None:
        return 0, 1
    init_method, rank, world, local = launch
    if dev.type == 'cuda':
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend or ('nccl' if dev.type == 'cuda' else 'gloo'),
        init_method=init_method, rank=rank, world_size=world, timeout=timeout)
    return rank, world
