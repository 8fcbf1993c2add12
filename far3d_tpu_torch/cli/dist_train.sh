#!/usr/bin/env bash
# Multi-host data-parallel training of the port (twin of tools/dist_train.sh;
# reference: tools/multi_dist_train.sh:5-38): one process a host joins one
# torch.distributed group over NCCL (parallel/mesh.py:init_distributed), on
# the host's first card (LOCAL_RANK, default 0).
#
# Run once per host:
#   COORDINATOR=host0:8476 NUM_HOSTS=2 HOST_ID=0 far3d_tpu_torch/cli/dist_train.sh \
#       --data-root data/av2 --work-dir work_dirs/far3d
#   COORDINATOR=host0:8476 NUM_HOSTS=2 HOST_ID=1 far3d_tpu_torch/cli/dist_train.sh ...
# Several cards a host: torchrun --nnodes ... --nproc_per_node N -m
# far3d_tpu_torch.cli.train ... (README).
set -euo pipefail

: "${COORDINATOR:?set COORDINATOR=host:port (the address of host 0)}"
: "${NUM_HOSTS:?set NUM_HOSTS}"
: "${HOST_ID:?set HOST_ID (0..NUM_HOSTS-1)}"

export FAR3D_COORDINATOR="$COORDINATOR"
export FAR3D_NUM_PROCESSES="$NUM_HOSTS"
export FAR3D_PROCESS_ID="$HOST_ID"
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

exec python -m far3d_tpu_torch.cli.train "$@"
