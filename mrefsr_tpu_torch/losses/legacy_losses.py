"""The loss module the Ref and MultiRef models fetch from by name (port of
``mrefsr_tpu/losses/legacy_losses.py``, the reference's second, unregistered
``basicsr/models/losses.py``). NHWC tensors. Apart from the modern stack
(re-exported here): the masked element-wise losses, a masked TV loss, the
perceptual loss with ``norm_img`` (inputs in [-1, 1] shifted to [0, 1]),
its sum over a stack of images, the WGAN-GP penalty flattened per sample,
SRNTT's texture (Gram) loss with swap-weight maps and the map loss.

Where the reference has latent faults the JAX package mends them, and so
does this port: the texture loss always computes its per-layer divisor
(the reference's ``div_num`` is undefined without ``use_weights``), as a
float; ``l2`` is a mean square; a masked TV loss without a mask is the
plain TV loss."""
import torch
import torch.nn.functional as F

from mrefsr_tpu_torch.archs.vgg_arch import VGGFeatureExtractor
from mrefsr_tpu_torch.ops.resize import interpolate

from .loss_util import masked_loss
from .losses import (CharbonnierLoss, GANLoss, L1Loss,  # noqa: F401
                     MSELoss, _feature_criterion, gradient_penalty_loss,
                     gram_mat, penalty_gradients, penalty_interpolates,
                     vgg_features)
from .losses import PerceptualLoss as _ModernPerceptualLoss


@masked_loss
def l1_loss(pred, target):
    return torch.abs(pred - target)


@masked_loss
def mse_loss(pred, target):
    return (pred - target) ** 2


@masked_loss
def charbonnier_loss(pred, target, eps=1e-6):
    return torch.sqrt((pred - target) ** 2 + eps)


class MaskedTVLoss(L1Loss):
    """Total variation as the L1 of neighbour differences, each weighted by
    the mask's rows and columns but the last (reference
    models/losses.py:125-138)."""

    def __init__(self, loss_weight=1.0):
        super().__init__(loss_weight=loss_weight)

    def __call__(self, pred, mask=None):
        y_diff = super().__call__(
            pred[:, :-1], pred[:, 1:],
            weight=None if mask is None else mask[:, :-1])
        x_diff = super().__call__(
            pred[:, :, :-1], pred[:, :, 1:],
            weight=None if mask is None else mask[:, :, :-1])
        return x_diff + y_diff


class PerceptualLoss(_ModernPerceptualLoss):
    """The perceptual loss with ``norm_img`` (default on): ``x`` and
    ``gt`` in [-1, 1] become ``(v + 1) / 2`` first (reference
    models/losses.py:141-240)."""

    def __init__(self, layer_weights, vgg_type='vgg19',
                 use_input_norm=True, perceptual_weight=1.0,
                 style_weight=0., norm_img=True, criterion='l1'):
        super().__init__(layer_weights, vgg_type=vgg_type,
                         use_input_norm=use_input_norm,
                         perceptual_weight=perceptual_weight,
                         style_weight=style_weight, criterion=criterion)
        self.norm_img = norm_img

    def __call__(self, x, gt):
        if self.norm_img:
            x = (x + 1.) * 0.5
            gt = (gt + 1.) * 0.5
        return super().__call__(x, gt)


class PerceptualLossMultiInputs(PerceptualLoss):
    """The perceptual loss summed over a stacked image axis, ``x`` and
    ``gt`` (B, N, H, W, C) (reference models/losses.py:241-272)."""

    def __call__(self, x, gt):
        if x.shape != gt.shape:
            raise ValueError('The sizes of input and GT should be the same.')
        total_percep, total_style = 0., 0.
        for i in range(x.shape[1]):
            percep, style = super().__call__(x[:, i], gt[:, i])
            total_percep = None if percep is None else total_percep + percep
            total_style = None if style is None else total_style + style
        return total_percep, total_style


class GradientPenaltyLoss:
    """WGAN-GP penalty with the gradient's norm over all of a sample
    (reference models/losses.py:402-429):
    ``loss(disc_fn, real, fake, alpha=None, generator=None, mask=None)``,
    ``alpha`` (B, 1, 1, 1) given or drawn from ``generator``."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, disc_fn, real_data, fake_data, alpha=None,
                 generator=None, mask=None):
        gradients = penalty_gradients(disc_fn, penalty_interpolates(
            real_data, fake_data, alpha, generator))
        if mask is not None:
            gradients = gradients * mask
        flat = gradients.reshape(gradients.shape[0], -1)
        norms = torch.sqrt((flat ** 2).sum(1) + 1e-12)
        return ((norms - 1) ** 2).mean() * self.loss_weight


def _edge_pad(x):
    """NHWC ``x`` padded by one pixel on each side, edges repeated."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode='replicate').permute(0, 2, 3, 1)


class TextureLoss:
    """SRNTT's texture loss: the Frobenius distance of the unnormalised
    Gram matrices of ``x``'s VGG taps and the swapped ``maps``, optionally
    under sigmoid swap-weight maps (reference models/losses.py:430-532).
    ``loss(x, maps, weights=0)``: ``x`` NHWC, ``maps`` NHWC per layer,
    ``weights`` an NHWC map (padded once, then resized bicubic with
    ``align_corners=True`` to each layer) or a dict of them per layer."""

    _DIV_NUM = {'relu3_1': 256, 'relu2_1': 512, 'relu1_1': 1024}
    _IDX = {'relu3_1': 0, 'relu2_1': 1, 'relu1_1': 2}

    def __init__(self, use_weights=False, loss_weight=1.0, vgg_type='vgg19',
                 layer_weights=None, use_input_norm=True):
        if layer_weights is None:
            layer_weights = {'relu1_1': 1.0, 'relu2_1': 1.0,
                             'relu3_1': 1.0}
        self.use_weights = use_weights
        self.loss_weight = loss_weight
        self.vgg = VGGFeatureExtractor(
            layer_name_list=tuple(layer_weights), vgg_type=vgg_type,
            use_input_norm=use_input_norm)

    @staticmethod
    def _gram(features):
        n, h, w, c = features.shape
        f = features.reshape(n, h * w, c).float()
        return f.transpose(1, 2) @ f

    def __call__(self, x, maps, weights=0):
        input_size = x.shape[2]
        x_features = vgg_features(self.vgg, x)
        maps = dict(maps)
        if self.use_weights and not isinstance(weights, dict):
            weights = _edge_pad(weights)
        losses = 0.
        for k in x_features:
            div_num = self._DIV_NUM[k]
            if self.use_weights:
                if isinstance(weights, dict):
                    w = _edge_pad(weights[k])
                else:
                    w = interpolate(weights, scale_factor=2 ** self._IDX[k],
                                    mode='bicubic', align_corners=True)
                coeff = torch.sigmoid(w * (-20.) + .65)
                maps[k] = maps[k] * coeff
                x_features[k] = x_features[k] * coeff
            diff = self._gram(x_features[k]) - self._gram(maps[k])
            losses = losses + torch.linalg.vector_norm(diff.reshape(-1)) \
                / 4. / (float(input_size * input_size * div_num) ** 2)
        return losses / 3. * self.loss_weight


class MapLoss:
    """The distance of swapped features to ``gt``'s VGG taps relu3_1,
    relu2_1 and relu1_1 (reference models/losses.py:535-594):
    ``loss(swapped_features, gt)``, NHWC; ``gt``'s features take no
    gradient."""

    def __init__(self, vgg_type='vgg19', map_weight=1.0, criterion='l1'):
        self.map_weight = map_weight
        self.vgg = VGGFeatureExtractor(
            layer_name_list=('relu3_1', 'relu2_1', 'relu1_1'),
            vgg_type=vgg_type)
        self.criterion_type = criterion
        self.criterion = _feature_criterion(criterion)

    def __call__(self, swapped_features, gt):
        with torch.no_grad():
            gt_features = vgg_features(self.vgg, gt.detach())
        map_loss = 0.
        for k in gt_features:
            if self.criterion is None:
                map_loss = map_loss + torch.linalg.vector_norm(
                    (swapped_features[k] - gt_features[k]).reshape(-1))
            else:
                map_loss = map_loss + self.criterion(swapped_features[k],
                                                     gt_features[k])
        return map_loss * self.map_weight
