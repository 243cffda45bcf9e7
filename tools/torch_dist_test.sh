#!/usr/bin/env bash
# Sharded testing with the PyTorch port, one process per card (parity:
# the reference's multi-process tools/test.py run).
#
#   "$ROOT"/tools/torch_dist_test.sh CONFIG N_PROCS [torch_test.py args...]
#
# torchrun starts N_PROCS processes of tools/torch_test.py on this host
# (NCCL over the cards; add --device cpu for gloo on the CPU); each
# predicts its shard of the dataset and process 0 writes the gathered
# results.  The kernels are built once here first.  PORT (default 29500)
# is the rendezvous port, PYTHON the interpreter.
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
  "$ROOT"/tools/torch_test.py "$CONFIG" "$@"
