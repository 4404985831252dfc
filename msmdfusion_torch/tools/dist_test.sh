#!/usr/bin/env bash
# Rank-sharded evaluation on GPUS cards of one machine:
#   msmdfusion_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS [test.py arguments]
# PORT (default 29500) is the rendezvous port on localhost; PYTHON (default
# python3) the interpreter whose torchrun (torch.distributed.run) starts the
# ranks.
set -euo pipefail
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
shift 3
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec "${PYTHON:-python3}" -m torch.distributed.run \
    --nproc_per_node "$GPUS" --master_addr 127.0.0.1 \
    --master_port "${PORT:-29500}" -m msmdfusion_torch.tools.test \
    "$CONFIG" "$CHECKPOINT" --launcher pytorch "$@"
