"""Pixel losses and total variation (port of
``mrefsr_tpu/losses/losses.py:43-118`` with the
weight-then-reduce contract of ``loss_util.py``; tensors are NHWC: the
channel axis of a weight map is the last one), the perceptual and style
loss over VGG taps (``:109-183``), the GAN loss with StyleGAN2's two
penalties (``:185-273``), the WGAN-GP penalty (``:276-294``), and
HiFaceGAN's multi-scale GAN loss and feature matching (``:232``,
``:297``)."""
import math

import torch
from torch.nn import functional as F

from mrefsr_tpu_torch.archs.vgg_arch import VGGFeatureExtractor

from .loss_util import weight_reduce_loss

_reduction_modes = ('none', 'mean', 'sum')


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


class CharbonnierLoss(_PixelLoss):
    """Charbonnier loss ``sqrt((pred - target)^2 + eps)`` (reference
    losses.py:86-118)."""

    def __init__(self, loss_weight=1.0, reduction='mean', eps=1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def elementwise(self, pred, target):
        return torch.sqrt((pred - target) ** 2 + self.eps)


class WeightedTVLoss(L1Loss):
    """Total variation: the L1 loss between each pixel and its lower and
    its right neighbour of NHWC ``pred``, under an optional weight map
    cropped alike, ``mean`` or ``sum`` (reference losses.py:120-146, JAX
    package losses.py:86-106)."""

    def __init__(self, loss_weight=1.0, reduction='mean'):
        if reduction not in ('mean', 'sum'):
            raise ValueError(f'Unsupported reduction mode: {reduction}. '
                             'Supported ones are: mean | sum')
        super().__init__(loss_weight, reduction)

    def __call__(self, pred, weight=None):
        y_weight = None if weight is None else weight[:, :-1]
        x_weight = None if weight is None else weight[:, :, :-1]
        y_diff = super().__call__(pred[:, :-1], pred[:, 1:], y_weight)
        x_diff = super().__call__(pred[:, :, :-1], pred[:, :, 1:], x_weight)
        return x_diff + y_diff


def gram_mat(x):
    """The Gram matrix of NHWC features over the positions, divided by
    ``c * h * w`` (reference losses.py:245-258): (N, C, C), f32 sums."""
    n, h, w, c = x.shape
    feats = x.reshape(n, h * w, c).float()
    return feats.transpose(1, 2) @ feats / (c * h * w)


def vgg_features(vgg, x):
    """``vgg``'s taps of NHWC ``x``, each NHWC."""
    return {k: v.permute(0, 2, 3, 1)
            for k, v in vgg(x.permute(0, 3, 1, 2)).items()}


def _feature_criterion(criterion):
    """``(a, b) -> loss`` of a perceptual loss's ``criterion``; None for
    ``fro``, whose norm runs over a whole tensor. ``l2`` is a mean square:
    the reference's branch names a class that does not exist
    (losses.py:189), the JAX package implements the intent."""
    if criterion == 'l1':
        return lambda a, b: torch.abs(a - b).mean()
    if criterion == 'l2':
        return lambda a, b: ((a - b) ** 2).mean()
    if criterion == 'fro':
        return None
    raise NotImplementedError(f'{criterion} criterion has not been '
                              'supported.')


class PerceptualLoss:
    """Perceptual and style loss over VGG taps (reference
    losses.py:149-258). ``loss(x, gt)`` on NHWC images returns
    ``(percep, style)``, each None where its weight is 0. The tower is
    :attr:`vgg`, a :class:`VGGFeatureExtractor` whose weights the model
    loads (``path.vgg_pretrain_path``) or seeds; ``gt``'s features take no
    gradient."""

    def __init__(self, layer_weights, vgg_type='vgg19', use_input_norm=True,
                 range_norm=False, perceptual_weight=1.0, style_weight=0.,
                 criterion='l1'):
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.layer_weights = dict(layer_weights)
        self.vgg = VGGFeatureExtractor(
            layer_name_list=tuple(layer_weights), vgg_type=vgg_type,
            use_input_norm=use_input_norm, range_norm=range_norm)
        self.criterion_type = criterion
        self.criterion = _feature_criterion(criterion)

    def _term(self, a, b):
        if self.criterion is None:
            return torch.linalg.vector_norm((a - b).reshape(-1))
        return self.criterion(a, b)

    def __call__(self, x, gt):
        x_features = vgg_features(self.vgg, x)
        with torch.no_grad():
            gt_features = vgg_features(self.vgg, gt.detach())
        percep_loss = None
        if self.perceptual_weight > 0:
            percep_loss = 0.
            for k in x_features:
                percep_loss = percep_loss + self._term(
                    x_features[k], gt_features[k]) * self.layer_weights[k]
            percep_loss = percep_loss * self.perceptual_weight
        style_loss = None
        if self.style_weight > 0:
            style_loss = 0.
            for k in x_features:
                style_loss = style_loss + self._term(
                    gram_mat(x_features[k]), gram_mat(gt_features[k])) \
                    * self.layer_weights[k]
            style_loss = style_loss * self.style_weight
        return percep_loss, style_loss


def penalty_interpolates(real_data, fake_data, alpha=None, generator=None):
    """``alpha * real + (1 - alpha) * fake``, ``alpha`` (B, 1, 1, 1)
    given or drawn U[0, 1) on the CPU from ``generator`` (so a seed gives
    the same draw on every device); the result requires a gradient."""
    if alpha is None:
        if generator is None:
            raise ValueError('a gradient penalty needs alpha or the '
                             'torch.Generator to draw it from')
        alpha = torch.rand((real_data.shape[0], 1, 1, 1),
                           generator=generator, dtype=real_data.dtype)
    alpha = alpha.to(device=real_data.device, dtype=real_data.dtype)
    interpolates = alpha * real_data + (1. - alpha) * fake_data
    if not interpolates.requires_grad:
        interpolates.requires_grad_(True)
    return interpolates


def penalty_gradients(disc_fn, interpolates):
    """d ``disc_fn(interpolates).sum()`` / d ``interpolates``, itself
    differentiable (the penalty's double backward)."""
    grads, = torch.autograd.grad(disc_fn(interpolates).sum(), interpolates,
                                 create_graph=True)
    return grads


def gradient_penalty_loss(disc_fn, real_data, fake_data, alpha=None,
                          generator=None, weight=None):
    """WGAN-GP penalty (reference losses.py:420-456) on NHWC images:
    ``disc_fn`` maps the interpolates to predictions; the norm of the
    gradient runs over the channel axis only, as the reference's; with a
    ``weight`` map the penalty is divided by its mean."""
    gradients = penalty_gradients(disc_fn, penalty_interpolates(
        real_data, fake_data, alpha, generator))
    if weight is not None:
        gradients = gradients * weight
    norms = torch.sqrt((gradients ** 2).sum(-1) + 1e-12)
    penalty = ((norms - 1) ** 2).mean()
    if weight is not None:
        penalty = penalty / weight.mean()
    return penalty


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


class MultiScaleGANLoss(GANLoss):
    """:class:`GANLoss` over a multi-scale discriminator's outputs
    (reference losses.py:364-388): for a list, the mean over the scales of
    each scale's loss on its last tensor (a scale's list of features ends
    with the prediction); a tensor as :class:`GANLoss`."""

    def __call__(self, x, target_is_real, is_disc=False):
        if not isinstance(x, list):
            return super().__call__(x, target_is_real, is_disc)
        loss = 0.
        for pred_i in x:
            if isinstance(pred_i, list):
                pred_i = pred_i[-1]
            loss = loss + super().__call__(pred_i, target_is_real,
                                           is_disc).mean()
        return loss / len(x)


class GANFeatLoss:
    """Feature matching over a multi-scale discriminator's stages
    (reference losses.py:460-492): ``criterion`` (``l1``, ``l2`` or
    ``charbonnier``, itself weighted by ``loss_weight``) between each
    scale's stage outputs but the last for the fake and the real images
    (the real ones detached), summed over stages, divided by the number of
    scales, then weighted by ``loss_weight`` again, as the reference
    does."""

    def __init__(self, criterion='l1', loss_weight=1.0, reduction='mean'):
        losses = {'l1': L1Loss, 'l2': MSELoss, 'charbonnier': CharbonnierLoss}
        if criterion not in losses:
            raise ValueError(f'Unsupported loss mode: {criterion}. '
                             'Supported ones are: l1|l2|charbonnier')
        self.loss_op = losses[criterion](loss_weight, reduction)
        self.loss_weight = loss_weight

    def __call__(self, pred_fake, pred_real):
        num_d = len(pred_fake)
        loss = 0.
        for fake, real in zip(pred_fake, pred_real):
            for j in range(len(fake) - 1):
                loss = loss + self.loss_op(fake[j], real[j].detach()) / num_d
        return loss * self.loss_weight


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
