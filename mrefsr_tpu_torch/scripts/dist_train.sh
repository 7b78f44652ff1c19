#!/usr/bin/env bash
# Training launcher of the port (the counterpart of scripts/dist_train.sh,
# which starts the JAX package).
#   usage: mrefsr_tpu_torch/scripts/dist_train.sh <num_gpus> <config> [args]
# One GPU: one process. More: torchrun starts one process a GPU on this
# host, each with batch_size_per_gpu samples a step. Run it from the root
# of a checkout.
GPUS=$1
CONFIG=$2
if [ "$GPUS" -le 1 ]; then
    exec python -m mrefsr_tpu_torch.train -opt "$CONFIG" "${@:3}"
else
    exec torchrun --nproc_per_node "$GPUS" \
        -m mrefsr_tpu_torch.train -opt "$CONFIG" --launcher pytorch "${@:3}"
fi
