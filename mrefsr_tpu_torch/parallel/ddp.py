"""Data-parallel training over ranks (the counterpart of
``mrefsr_tpu/parallel/mesh.py`` in a run of several processes).

The JAX package shards each batch over a ``data`` mesh, each process
contributing its own rows (``put_sharded``, mesh.py:62-80), replicates the
parameters, and XLA all-reduces the gradients. Here every rank is one
process that feeds its own batch to its own copy of the net
(``feed_data`` places it on the rank's device), and
``DistributedDataParallel`` averages the gradients in the backward. With
equal batches on every rank that is the gradient of the global batch's
mean loss, the JAX step's.
"""
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def data_parallel(net, device):
    """``net`` (already on ``device``, an indexed device for CUDA, its
    trainable parameters set)
    wrapped for data-parallel training over the default group. Rank 0's
    parameters are broadcast to every rank here.

    Every parameter must get a gradient in each step
    (``find_unused_parameters`` stays off: an unused one raises on the
    next step rather than costing a graph walk each step). The gradients
    live in the all-reduce buckets (``gradient_as_bucket_view``), in the
    parameters' own strides, channels-last included, so DDP copies none.
    Under bf16 mixed precision the model calls the wrapper through
    ``torch.func.functional_call`` with bf16 copies of these parameters,
    made inside the forward by a differentiable cast: DDP's hooks stay on
    the f32 parameters, and each gradient reaches them once, through the
    cast.
    """
    device_ids = [device.index] if device.type == 'cuda' else None
    return DistributedDataParallel(net, device_ids=device_ids,
                                   gradient_as_bucket_view=True)


def all_reduce_mean(tensors):
    """The mean over the ranks of each of ``tensors`` (0-d, on this
    rank's device: NCCL reduces no CPU tensor), in one all-reduce;
    ``tensors`` themselves outside a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return list(tensors)
    stacked = torch.stack([t.detach().reshape(()) for t in tensors])
    dist.all_reduce(stacked)
    return list(stacked / dist.get_world_size())
