#!/usr/bin/env bash
# Test launcher of the port (the counterpart of scripts/dist_test.sh,
# which starts the JAX package).
#   usage: mrefsr_tpu_torch/scripts/dist_test.sh <num_gpus> <config> [args]
# One GPU: one process. More: torchrun starts one process a GPU on this
# host, each with its share of the images. Run it from the root
# of a checkout.
GPUS=$1
CONFIG=$2
if [ "$GPUS" -le 1 ]; then
    exec python -m mrefsr_tpu_torch.test -opt "$CONFIG" "${@:3}"
else
    exec torchrun --nproc_per_node "$GPUS" \
        -m mrefsr_tpu_torch.test -opt "$CONFIG" --launcher pytorch "${@:3}"
fi
