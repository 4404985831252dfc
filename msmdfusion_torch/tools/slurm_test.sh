#!/usr/bin/env bash
# SLURM evaluation launcher (reference tools/slurm_test.sh):
#   GPUS=<tasks> msmdfusion_torch/tools/slurm_test.sh PARTITION JOB_NAME CONFIG CHECKPOINT [test arguments]
# srun starts GPUS tasks, GPUS_PER_NODE (default 8, at most GPUS) on each
# node with as many cards; each runs the port's test CLI with
# --launcher manual, its rendezvous exported from SLURM's variables as the
# JAX package's script does: MSMD_COORDINATOR (unless set) the first host of
# SLURM_JOB_NODELIST at port PORT (default 29500), MSMD_NUM_PROCESSES
# SLURM_NTASKS, MSMD_PROCESS_ID SLURM_PROCID (each task on the card
# MSMD_PROCESS_ID modulo the node's cards). CPUS_PER_TASK (default 5),
# SRUN_ARGS (extra srun options) and PYTHON (default python3) as named.
set -euo pipefail
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
shift 4
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
GPUS_PER_NODE=$(( GPUS_PER_NODE < GPUS ? GPUS_PER_NODE : GPUS ))
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
export MSMD_PORT=${PORT:-29500}
# shellcheck disable=SC2086,SC2016
exec srun -p "$PARTITION" --job-name="$JOB_NAME" --ntasks="$GPUS" \
    --ntasks-per-node="$GPUS_PER_NODE" --gres=gpu:"$GPUS_PER_NODE" \
    --cpus-per-task="${CPUS_PER_TASK:-5}" --kill-on-bad-exit=1 \
    ${SRUN_ARGS:-} \
    bash -c 'export MSMD_COORDINATOR="${MSMD_COORDINATOR:-$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1):$MSMD_PORT}"
export MSMD_NUM_PROCESSES="$SLURM_NTASKS" MSMD_PROCESS_ID="$SLURM_PROCID"
exec "${PYTHON:-python3}" -u -m msmdfusion_torch.tools.test "$@"' \
    bash "$CONFIG" "$CHECKPOINT" --launcher manual "$@"
