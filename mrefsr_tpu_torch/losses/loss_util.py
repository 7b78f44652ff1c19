"""The weight-then-reduce contract of the element-wise losses (port of
``mrefsr_tpu/losses/loss_util.py:1-53``). Tensors are NHWC: a weight map
has 1 or C channels on the last axis."""
import functools


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
    if reduction != 'mean':
        raise ValueError(f'invalid reduction: {reduction}')
    if weight is None:
        return loss.mean()
    denom = weight.sum()
    if weight.shape[-1] == 1:
        denom = denom * loss.shape[-1]
    return loss.sum() / denom


def weighted_loss(loss_func):
    """Give an element-wise ``loss_func(pred, target, **kwargs)`` the
    arguments ``weight`` and ``reduction`` (reference loss_util.py:59-95;
    the legacy ``masked_loss`` of models/loss_utils.py:58-96 is the same
    contract)."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction='mean', **kwargs):
        return weight_reduce_loss(loss_func(pred, target, **kwargs), weight,
                                  reduction)

    return wrapper


masked_loss = weighted_loss
