"""Pixel losses (port of ``mrefsr_tpu/losses/losses.py:43-70`` with the
weight-then-reduce contract of ``loss_util.py``). Tensors are NHWC: the
channel axis of a weight map is the last one."""
import torch

_reduction_modes = ('none', 'mean', 'sum')


def weight_reduce_loss(loss, weight=None, reduction='mean'):
    """Apply an element-wise weight, then reduce. With a weight and
    ``'mean'``, the mean runs over the weighted region (the weight's sum,
    times C for a one-channel weight)."""
    if weight is not None:
        if weight.dim() != loss.dim() or weight.shape[-1] not in (
                1, loss.shape[-1]):
            raise ValueError(f'weight {tuple(weight.shape)} does not fit a '
                             f'loss of shape {tuple(loss.shape)}')
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if weight is None:
        return loss.mean()
    denom = weight.sum()
    if weight.shape[-1] == 1:
        denom = denom * loss.shape[-1]
    return loss.sum() / denom


class _PixelLoss:
    """``loss_weight * reduce(elementwise(pred, target) * weight)``."""

    def __init__(self, loss_weight=1.0, reduction='mean'):
        if reduction not in _reduction_modes:
            raise ValueError(f'Unsupported reduction mode: {reduction}. '
                             f'Supported ones are: {_reduction_modes}')
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * weight_reduce_loss(
            self.elementwise(pred, target), weight, self.reduction)


class L1Loss(_PixelLoss):
    """L1 loss (reference losses.py:30-55)."""

    @staticmethod
    def elementwise(pred, target):
        return torch.abs(pred - target)


class MSELoss(_PixelLoss):
    """MSE loss (reference losses.py:58-83)."""

    @staticmethod
    def elementwise(pred, target):
        return (pred - target) ** 2
