"""HiFaceGANModel: face renovation with a conditional multi-scale
discriminator and feature matching (port of
``mrefsr_tpu/models/hifacegan_model.py``, the reference's
basicsr/models/hifacegan_model.py:15-288), on :class:`SRGANModel`'s
alternation, schedules, ``save`` and resume.

One step is the JAX step's, f32 (it casts nothing; ``val.mixed_precision``
serves ``SRModel.test``):

* ``net_g`` runs forward in training mode, so its spectral-norm convs take
  a power iteration and keep it, on every iteration. On a generator turn
  (``i % net_d_iters == 0`` and ``i > net_d_init_iters``) its terms take
  one optimizer step: ``l_g_pix``, ``l_g_percep`` / ``l_g_style``,
  ``l_g_gan`` (:class:`~mrefsr_tpu_torch.losses.MultiScaleGANLoss` on the
  fake scales, judged real) and ``l_g_feat``
  (:class:`~mrefsr_tpu_torch.losses.GANFeatLoss`); off a turn they log as
  0. In this pass ``net_d`` runs in eval mode, so its spectral-norm convs
  take sigma from their stored ``u`` / ``v`` and iterate nothing, as the
  JAX step applies it with ``spectral`` immutable (its norms do not depend
  on the mode).
* ``net_d`` then steps on ``(l_d_real + l_d_fake) / 2`` over the detached
  output, its power iteration kept.

Fake and real go through ``net_d`` as one batch, each the channel
concatenation of ``lq`` and the image, and are split in halves
(:meth:`HiFaceGANModel.divide_pred`). No EMA: a nonzero ``ema_decay``
raises, as in the JAX package.
"""
from collections import OrderedDict

import torch

from mrefsr_tpu_torch.convert import (load_keeping_buffers,
                                      state_dict_from_flax_with_counts)
from mrefsr_tpu_torch.losses import build_loss
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .sr_model import SRModel
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class HiFaceGANModel(SRGANModel):
    """HiFaceGAN's training strategy (module docstring)."""

    def init_training_settings(self):
        """:class:`SRGANModel`'s nets, losses, optimizers and schedules,
        and the feature-matching loss ``train.feature_matching_opt``."""
        train_opt = self.opt['train']
        if train_opt.get('ema_decay', 0) > 0:
            raise NotImplementedError(
                'HiFaceGAN does not support EMA now. Pass')
        super().init_training_settings()
        self.cri_feat = build_loss(train_opt['feature_matching_opt']) \
            if train_opt.get('feature_matching_opt') else None

    def check_losses(self):
        """A pixel or a perceptual loss must train ``net_g``."""
        SRModel.check_losses(self)

    def load_from_flax(self, variables):
        """Take the JAX package's flax variables of ``network_g``: the
        parameters, the spectral-norm vectors and any frozen norm's
        statistics."""
        load_keeping_buffers(self.get_bare_model(self.net_g),
                             state_dict_from_flax_with_counts(variables))

    @staticmethod
    def divide_pred(pred):
        """Each scale's stage outputs split into the first half of the
        batch (fake) and the second (real) (reference hifacegan_model.py:
        99-115)."""
        fake = [[t[:t.shape[0] // 2] for t in p] for p in pred]
        real = [[t[t.shape[0] // 2:] for t in p] for p in pred]
        return fake, real

    def discriminate(self, output, gt):
        """``net_d`` on ``(lq, output)`` and ``(lq, gt)`` (NHWC) as one
        batch; returns the fake and the real predictions."""
        fake_and_real = torch.cat([torch.cat([self.lq, output], -1),
                                   torch.cat([self.lq, gt], -1)], 0)
        return self.divide_pred(self.net_d(fake_and_real.permute(0, 3, 1,
                                                                 2)))

    def g_loss_keys(self):
        keys = super().g_loss_keys()
        return keys + ['l_g_feat'] if self.cri_feat is not None else keys

    def g_losses(self, output):
        """The generator's terms: pixel, perceptual and style, the GAN term
        and feature matching, ``net_d`` on its stored vectors."""
        losses = OrderedDict()
        for key, value in self.losses(output, self.gt).items():
            losses[key.replace('l_', 'l_g_', 1)] = value
        training = self.net_d.training
        self.net_d.eval()
        try:
            pred_fake, pred_real = self.discriminate(output, self.gt)
        finally:
            self.net_d.train(training)
        losses['l_g_gan'] = self.cri_gan(pred_fake, True, is_disc=False)
        if self.cri_feat is not None:
            losses['l_g_feat'] = self.cri_feat(pred_fake, pred_real)
        return losses

    def d_losses(self, fake):
        """The discriminator's terms on ``fake`` (detached) and ``gt``; the
        loss is their mean."""
        pred_fake, pred_real = self.discriminate(fake, self.gt)
        return OrderedDict(
            l_d_real=self.cri_gan(pred_real, True, is_disc=True),
            l_d_fake=self.cri_gan(pred_fake, False, is_disc=True))

    @staticmethod
    def d_total(d_losses):
        """The discriminator's loss: ``(l_d_real + l_d_fake) / 2``."""
        return (d_losses['l_d_real'] + d_losses['l_d_fake']) / 2
