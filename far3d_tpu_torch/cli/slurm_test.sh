#!/usr/bin/env bash
# Slurm launcher of the port's multi-process evaluation (twin of
# tools/slurm_test.sh; reference: tools/slurm_test.sh): one task a card, each
# streaming its shard of the val set; rank 0 scores every rank's frames
# (eval/runner.py:collect_and_evaluate). See slurm_train.sh for the
# rendezvous.
#
#   far3d_tpu_torch/cli/slurm_test.sh <partition> <job-name> [cli.test args...]
set -euo pipefail

PARTITION=$1
JOB_NAME=$2
shift 2
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
    python -u -m far3d_tpu_torch.cli.test "$@"
