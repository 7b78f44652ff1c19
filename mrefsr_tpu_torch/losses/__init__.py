"""Losses of the port (port of ``mrefsr_tpu/losses``). The multi-ref
models fetch theirs by name from :mod:`.legacy_losses`; a ``pixel_opt``,
``perceptual_opt``, ``gan_opt`` or ``feature_matching_opt`` block names
its class by ``type``, which :func:`build_loss` looks up here."""
from copy import deepcopy

from .losses import (CharbonnierLoss, GANFeatLoss, GANLoss, L1Loss,
                     MSELoss, MultiScaleGANLoss, PerceptualLoss,
                     WeightedTVLoss, g_path_regularize, r1_penalty)

__all__ = ['CharbonnierLoss', 'GANFeatLoss', 'GANLoss', 'L1Loss', 'MSELoss',
           'MultiScaleGANLoss', 'PerceptualLoss', 'WeightedTVLoss',
           'build_loss', 'g_path_regularize', 'r1_penalty']

_LOSSES = {'CharbonnierLoss': CharbonnierLoss, 'GANFeatLoss': GANFeatLoss,
           'GANLoss': GANLoss, 'L1Loss': L1Loss, 'MSELoss': MSELoss,
           'MultiScaleGANLoss': MultiScaleGANLoss,
           'PerceptualLoss': PerceptualLoss,
           'WeightedTVLoss': WeightedTVLoss}


def build_loss(opt):
    """Instantiate a loss from its options dict (``type`` plus the
    constructor's keyword arguments)."""
    opt = deepcopy(opt)
    loss_type = opt.pop('type')
    if loss_type not in _LOSSES:
        raise KeyError(f'loss {loss_type!r} is not ported; available: '
                       f'{sorted(_LOSSES)}')
    return _LOSSES[loss_type](**opt)
