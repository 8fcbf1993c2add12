#!/usr/bin/env bash
# Slurm launcher of the port's data-parallel training (twin of
# tools/slurm_train.sh; reference: tools/slurm_train.sh): one task a card;
# parallel/mesh.py:init_distributed reads SLURM_PROCID, SLURM_NTASKS and
# SLURM_LOCALID and meets at MASTER_ADDR (default: the job's first host) and
# MASTER_PORT (default 29500) over NCCL.
#
#   far3d_tpu_torch/cli/slurm_train.sh <partition> <job-name> <work-dir> [cli.train args...]
set -euo pipefail

PARTITION=$1
JOB_NAME=$2
WORK_DIR=$3
shift 3
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
SRUN_ARGS=${SRUN_ARGS:-""}
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

srun -p "${PARTITION}" \
    --job-name="${JOB_NAME}" \
    --gres=gpu:"${GPUS_PER_NODE}" \
    --ntasks="${GPUS}" \
    --ntasks-per-node="${GPUS_PER_NODE}" \
    --cpus-per-task="${CPUS_PER_TASK}" \
    --kill-on-bad-exit=1 \
    ${SRUN_ARGS} \
    python -u -m far3d_tpu_torch.cli.train --work-dir="${WORK_DIR}" "$@"
