#!/usr/bin/env bash
# Data-parallel training with the PyTorch port, one process per card
# (parity: tools/dist_train.sh, the reference's
# `torch.distributed.launch --nproc_per_node` wrapper).
#
#   "$ROOT"/tools/torch_dist_train.sh CONFIG N_PROCS [torch_train.py args...]
#
# torchrun starts N_PROCS processes of tools/torch_train.py on this host
# (NCCL over the cards; add --device cpu for gloo on the CPU); the
# global batch is split over them.  The kernels are built once here
# first, so that the processes do not each run nvcc.  PORT (default
# 29500) is the rendezvous port, PYTHON the interpreter.
set -eu
CONFIG=$1
NPROCS=$2
shift 2
PY=${PYTHON:-python3}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
case " $* " in
  *" --device cpu "*) ;;
  *) PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" "$PY" -m aidet_tpu_torch.cuda_build ;;
esac
exec "$PY" -m torch.distributed.run --nproc_per_node "$NPROCS" \
  --master_addr 127.0.0.1 --master_port "${PORT:-29500}" \
  "$ROOT"/tools/torch_train.py "$CONFIG" "$@"
