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

The GAN phase's discriminator is not wrapped. One discriminator loss holds
three forwards (real, fake and the gradient penalty's interpolates) and a
``torch.autograd.grad(create_graph=True)`` inside, and the generator's loss
runs it a fourth time; DDP pairs each forward with one backward and by
default broadcasts rank 0's buffers at every forward, which would overwrite
the running statistics the real and fake passes write. So the model keeps
``net_d`` bare: :func:`broadcast_module` makes the ranks start equal,
:func:`all_reduce_grads_mean` averages its gradients after the backward,
and its norms reduce their statistics over the ranks themselves
(:mod:`.batch_norm`), so every rank holds the same running statistics.
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


def broadcast_module(net):
    """Rank 0's parameters and buffers of ``net`` to every rank, in place;
    nothing outside a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    with torch.no_grad():
        for tensor in net.state_dict().values():
            dist.broadcast(tensor, 0)


def all_reduce_grads_mean(params):
    """The gradients of ``params`` averaged over the ranks, in place, in
    one all-reduce (what DDP's backward does for a wrapped net); nothing
    outside a process group."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
