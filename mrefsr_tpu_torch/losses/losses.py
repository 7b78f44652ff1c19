"""Pixel losses (port of ``mrefsr_tpu/losses/losses.py:43-70`` with the
weight-then-reduce contract of ``loss_util.py``; tensors are NHWC: the
channel axis of a weight map is the last one), and the GAN loss with
StyleGAN2's two penalties (``losses.py:185-273``)."""
import math

import torch
from torch.nn import functional as F

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


class GANLoss:
    """GAN loss: vanilla / lsgan / wgan / wgan_softplus / hinge
    (reference losses.py:259-361). For the discriminator
    (``is_disc=True``) the loss weight is always 1."""

    def __init__(self, gan_type, real_label_val=1.0, fake_label_val=0.0,
                 loss_weight=1.0):
        if gan_type not in ('vanilla', 'lsgan', 'wgan', 'wgan_softplus',
                            'hinge'):
            raise NotImplementedError(
                f'GAN type {gan_type} is not implemented.')
        self.gan_type = gan_type
        self.loss_weight = loss_weight
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val

    def _base_loss(self, x, target_is_real):
        label = self.real_label_val if target_is_real \
            else self.fake_label_val
        if self.gan_type == 'vanilla':
            return F.binary_cross_entropy_with_logits(
                x, torch.full_like(x, label))
        if self.gan_type == 'lsgan':
            return torch.mean((x - label) ** 2)
        if self.gan_type == 'wgan':
            return -x.mean() if target_is_real else x.mean()
        # wgan_softplus
        return F.softplus(-x).mean() if target_is_real \
            else F.softplus(x).mean()

    def __call__(self, x, target_is_real, is_disc=False):
        if self.gan_type == 'hinge':
            if is_disc:
                x = -x if target_is_real else x
                loss = torch.relu(1 + x).mean()
            else:
                loss = -x.mean()
        else:
            loss = self._base_loss(x, target_is_real)
        return loss if is_disc else loss * self.loss_weight


def r1_penalty(real_pred, real_img):
    """R1 gradient penalty on real data (reference losses.py:391-405):
    the batch mean of the squared norm of d ``real_pred.sum()`` /
    d ``real_img``. ``real_pred`` is the discriminator's output on
    ``real_img``, which must require a gradient; the result can be
    differentiated again in the discriminator's parameters."""
    grad_real, = torch.autograd.grad(real_pred.sum(), real_img,
                                     create_graph=True)
    return grad_real.pow(2).reshape(grad_real.shape[0], -1).sum(1).mean()


def g_path_regularize(fake_img, latents, mean_path_length, decay=0.01,
                      noise=None, generator=None):
    """StyleGAN2 path-length regularization (reference losses.py:408-417).
    ``fake_img`` (b, c, h, w) is the generator's output for ``latents``
    (b, num_latent, num_style_feat), which must be part of its graph. The
    image is weighted by ``noise / sqrt(h * w)``, with ``noise`` of the
    image's shape given or drawn N(0, 1) from ``generator``. Returns
    ``(penalty, path_lengths.mean() detached, the new mean path length
    detached)``; the penalty can be differentiated again."""
    if noise is None:
        if generator is None:
            raise ValueError('g_path_regularize needs noise or the '
                             'torch.Generator to draw it from')
        noise = torch.randn(fake_img.shape, generator=generator,
                            dtype=fake_img.dtype, device=fake_img.device)
    noise = noise / math.sqrt(fake_img.shape[2] * fake_img.shape[3])
    grad, = torch.autograd.grad((fake_img * noise).sum(), latents,
                                create_graph=True)
    path_lengths = torch.sqrt(grad.pow(2).sum(2).mean(1))
    path_mean = mean_path_length + decay * (path_lengths.mean()
                                            - mean_path_length)
    path_penalty = (path_lengths - path_mean).pow(2).mean()
    return path_penalty, path_lengths.detach().mean(), path_mean.detach()
