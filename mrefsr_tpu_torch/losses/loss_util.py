"""The weight-then-reduce contract of the element-wise losses (port of
``mrefsr_tpu/losses/loss_util.py``), and the LDL artifact map of
Real-ESRGAN's ``train.ldl_opt`` (:func:`get_refined_artifact_map`).
Tensors are NHWC: a weight map has 1 or C channels on the last axis."""
import functools

import torch
import torch.nn.functional as F


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


def get_local_weights(residual, ksize):
    """The unbiased variance of ``residual`` (B, H, W, 1) over each
    ``ksize`` x ``ksize`` window, reflect-padded (reference
    basicsr/losses/loss_util.py:96-118): (s2 - s1^2 / n) / (n - 1) of the
    window's sums s1 of x and s2 of x^2, n = ksize^2."""
    pad = (ksize - 1) // 2
    x = F.pad(residual.permute(0, 3, 1, 2), (pad, pad, pad, pad),
              mode='reflect')
    n = ksize * ksize
    s1 = F.avg_pool2d(x, ksize, stride=1, divisor_override=1)
    s2 = F.avg_pool2d(x * x, ksize, stride=1, divisor_override=1)
    return ((s2 - s1 * s1 / n) / (n - 1)).permute(0, 2, 3, 1)


def get_refined_artifact_map(img_gt, img_output, img_ema, ksize):
    """LDL's artifact map (reference loss_util.py:121-145), NHWC (B, H, W,
    1): the channel sum of |gt - output|'s variance over the image to the
    1/5 (ddof 1) times its local variance (:func:`get_local_weights`), and
    0 where the output is closer to ``gt`` than the EMA's output
    ``img_ema`` is."""
    residual_ema = (img_gt - img_ema).abs().sum(-1, keepdim=True)
    residual_sr = (img_gt - img_output).abs().sum(-1, keepdim=True)
    patch_level_weight = torch.var(residual_sr, dim=(1, 2, 3), keepdim=True,
                                   correction=1) ** (1 / 5)
    overall_weight = patch_level_weight * get_local_weights(residual_sr,
                                                            ksize)
    return torch.where(residual_sr < residual_ema,
                       torch.zeros_like(overall_weight), overall_weight)
