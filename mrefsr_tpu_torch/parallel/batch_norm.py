"""Batch norm with the JAX package's statistics, over the global batch.

The JAX package's discriminator normalises with flax's
``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, and the port must keep three
things of it that torch's ``BatchNorm2d`` and ``SyncBatchNorm`` do not:

* **the stored variance is the biased one**: flax keeps
  ``max(E[x^2] - E[x]^2, 0)``, torch the unbiased variance, n / (n - 1)
  larger (n is 2 in the last block of a gt-32, batch-2 discriminator);
* **which forwards write the running statistics**: the JAX GAN step keeps
  the updates of the discriminator step's real and fake passes only; the
  gradient penalty's pass and the generator step's pass normalise by their
  own batch but drop their updates. Here every forward in training mode
  normalises by its batch, and writes the running statistics only while
  :attr:`BatchNorm2d.update_stats` is set (:func:`frozen_stats` clears it
  for a block of code);
* **the batch is the global one**: under the JAX data mesh a jitted mean
  runs over every device's rows. With :attr:`BatchNorm2d.sync` set (the
  model sets it in a run of several ranks) this module adds the
  per-channel count, sum and sum of squares over the ranks by
  :func:`all_reduce_sum`, an all-reduce that autograd differentiates to
  any order (its backward is itself), which the gradient penalty's double
  backward needs; ``SyncBatchNorm``'s backward is not differentiable again.

flax's ``momentum=0.9`` (the weight of the old value) is torch's
``momentum=0.1`` (the weight of the new one), the value this module takes.
:class:`BatchNorm3d` is the same norm on NCDHW (DUF's).
"""
import contextlib

import torch
import torch.distributed as dist
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum of the ranks'
    gradients, computed by this same Function, so a double backward
    reduces again."""

    @staticmethod
    def forward(ctx, tensor):
        tensor = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(tensor)
        return tensor

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(tensor):
    """``tensor`` summed over the ranks of the default group,
    differentiably to any order. Collective: every rank calls it, and
    every backward through it."""
    return _AllReduceSum.apply(tensor)


class BatchNorm2d(nn.Module):
    """flax's ``nn.BatchNorm`` on NCHW, with torch's parameter and buffer
    names (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), so reference checkpoints load. See the
    module docstring for the statistics."""

    def __init__(self, num_features, momentum=0.1, eps=1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.update_stats = True
        self.sync = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1)
        self.num_batches_tracked.zero_()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the JAX package's checkpoints carry no num_batches_tracked
        state_dict.setdefault(prefix + 'num_batches_tracked',
                              torch.zeros_like(self.num_batches_tracked))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def batch_stats(self, x):
        """``(mean, var)`` of ``x`` per channel (over every dimension but
        1), over every rank's batch where :attr:`sync` is set, f32, the
        variance biased (flax's ``use_fast_variance``)."""
        c = x.shape[1]
        x = x.float()
        count = x.new_full((1,), x.numel() // c)
        dims = (0, *range(2, x.dim()))
        sums = torch.cat([x.sum(dims), (x * x).sum(dims), count])
        if self.sync:
            sums = all_reduce_sum(sums)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0)
        return mean, var

    def forward(self, x):
        if self.training:
            mean, var = self.batch_stats(x)
            if self.update_stats:
                with torch.no_grad():
                    keep = 1.0 - self.momentum
                    self.running_mean.mul_(keep).add_(
                        mean.to(self.running_mean.dtype) * (1.0 - keep))
                    self.running_var.mul_(keep).add_(
                        var.to(self.running_var.dtype) * (1.0 - keep))
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean.view(shape).to(x.dtype))
                * mul.view(shape).to(x.dtype)
                + self.bias.view(shape).to(x.dtype))


class BatchNorm3d(BatchNorm2d):
    """:class:`BatchNorm2d` on NCDHW: the statistics over N, D, H and W."""


@contextlib.contextmanager
def frozen_stats(module):
    """Within the block, the :class:`BatchNorm2d` layers of ``module``
    still normalise by their batch in training mode but leave their
    running statistics as they are; so do the spectral-norm convs
    (:class:`~mrefsr_tpu_torch.archs.arch_util.SNConv2d`, whose state is
    their power iteration's vectors): every submodule with an
    ``update_stats`` flag."""
    norms = [m for m in module.modules() if hasattr(m, 'update_stats')]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag
