"""SRGANModel: a generator trained against a discriminator (port of
``mrefsr_tpu/models/srgan_model.py``, the reference's
basicsr/models/srgan_model.py:12-149); the video GAN models subclass it.

One step is the JAX step's, in f32 whatever ``train.mixed_precision``
says (the JAX step casts nothing; ``val.mixed_precision`` serves as
``SRModel``'s):

* ``net_g`` runs forward once. On a generator turn (iteration ``i`` with
  ``i % net_d_iters == 0`` and ``i > net_d_init_iters``) its pixel,
  perceptual and GAN losses (``l_g_pix``, ``l_g_percep``, ``l_g_style``,
  ``l_g_gan``) take one optimizer step, the freeze schedule zeroing the
  frozen gradients; off a turn they log as 0 and ``net_g`` stays.
* ``net_d`` then steps on the real ``gt`` and the detached output (the
  output before ``net_g``'s update, as the reference trains it):
  ``l_d_real``, ``l_d_fake``, ``out_d_real``, ``out_d_fake``.
* The EMA follows ``net_g`` every iteration.

``net_d`` stays in training mode: its norms use their batch's statistics
in every pass and write their running statistics in the discriminator
step's two passes only (the real one first), as the JAX step keeps them
(:func:`~mrefsr_tpu_torch.parallel.batch_norm.frozen_stats` around the
generator's pass). A clip's frames (B, T, H, W, 3) go through ``net_d``
and the VGG as a batch. Each optimizer's schedule counts its own updates,
as optax does: ``net_g``'s misses the iterations off a turn.

Under ``dist`` ``net_d`` is not wrapped in DDP: its gradients are averaged
over the ranks by ``all_reduce_grads_mean`` and its norms' statistics
taken over the global batch (``sync``). ``save`` writes ``net_d_<iter>
.pth`` beside ``net_g_<iter>.pth``; the ``.state`` holds both optimizers
and both schedulers, G then D. ``ESRGANModel`` (``models/esrgan_model.py``)
replaces the GAN terms of both steps by their relativistic form
(:meth:`SRGANModel.g_gan_loss`, :meth:`SRGANModel.d_losses`).

Two hooks of Real-ESRGAN (JAX package srgan_model.py:49-50, 158-167,
272):

* ``train.ldl_opt`` adds ``l_g_ldl`` after the pixel term: the loss of
  ``map * output`` against ``map * gt``, the map
  :func:`~mrefsr_tpu_torch.losses.loss_util.get_refined_artifact_map` of
  ``gt``, the output and the EMA net's output on the same ``lq`` (before
  this step's EMA update, no gradient; the map itself passes the output's
  gradient, as the JAX step's does). It needs ``ema_decay``.
* :meth:`SRGANModel._train_step_inputs` gives each term its target: ``lq``
  and the ``gt`` of the pixel, perceptual, GAN (the discriminator's real
  images) and LDL terms, ``gt`` for all four here; ``RealESRGANModel``
  routes its sharpened ``gt`` to some of them.
"""
from collections import OrderedDict

import torch

from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.archs.discriminator_arch import VGGStyleDiscriminator
from mrefsr_tpu_torch.convert import (
    state_dict_from_flax_variables,
    vgg_style_discriminator_state_dict_from_flax)
from mrefsr_tpu_torch.losses import build_loss
from mrefsr_tpu_torch.losses.loss_util import get_refined_artifact_map
from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d, frozen_stats
from mrefsr_tpu_torch.parallel.ddp import (all_reduce_grads_mean,
                                           broadcast_module)
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .sr_model import SRModel, build_optimizer


def _frames_as_batch(x):
    """An NHWC clip (B, T, H, W, C) as a batch of frames; an image as it
    is."""
    return x.flatten(0, 1) if x.dim() == 5 else x


@MODEL_REGISTRY.register()
class SRGANModel(SRModel):
    """``network_g`` against ``network_d`` (module docstring)."""

    def __init__(self, opt, device=None):
        self.net_d = None
        super().__init__(opt, device)
        if self.is_train and opt.get('dist'):
            broadcast_module(self.net_d)
            for m in self.net_d.modules():
                if isinstance(m, BatchNorm2d):
                    m.sync = True

    # ------------------------------------------------------------- training
    def init_training_settings(self):
        """``SRModel``'s losses, EMA and ``net_g`` optimizer, then
        ``net_d`` (seeded from ``manual_seed + 1``, or
        ``path.pretrain_network_d``), the GAN loss, ``net_d``'s optimizer
        and both schedules (JAX package srgan_model.py:31-70)."""
        train_opt = self.opt['train']
        with torch.device('meta'):
            self.net_d = build_network(self.opt['network_d'])
        self.net_d.to_empty(device=self.device)
        self.net_d.init_weights(torch.Generator().manual_seed(
            (self.opt.get('manual_seed') or 0) + 1))
        file = self.named_file('pretrain_network_d')
        if file:
            path = self.opt['path']
            self.load_network(self.net_d, file,
                              path.get('strict_load_d', True),
                              path.get('param_key_d', 'params'))
        self.net_d.train().requires_grad_(False)
        self.cri_gan = build_loss(train_opt['gan_opt'])
        self.net_d_iters = train_opt.get('net_d_iters', 1)
        self.net_d_init_iters = train_opt.get('net_d_init_iters', 0)
        super().init_training_settings()
        self.cri_ldl = build_loss(train_opt['ldl_opt']) \
            if train_opt.get('ldl_opt') else None
        if self.cri_ldl is not None and self.net_g_ema is None:
            raise ValueError('train.ldl_opt needs train.ema_decay > 0: the '
                             "artifact map compares with the EMA net's output")
        optim_opt = dict(train_opt['optim_d'])
        self.optimizer_d = build_optimizer(
            [{'params': list(self.net_d.parameters()),
              'lr': optim_opt.pop('lr')}], optim_opt)
        self.optimizers.append(self.optimizer_d)
        self.setup_schedulers()

    def check_losses(self):
        """The GAN loss trains ``net_g`` without a pixel or perceptual
        loss."""

    def load_net_d_from_flax(self, variables):
        """Take the JAX package's flax variables of ``network_d``
        (``params`` and ``batch_stats``)."""
        to_state = vgg_style_discriminator_state_dict_from_flax \
            if isinstance(self.net_d, VGGStyleDiscriminator) \
            else state_dict_from_flax_variables
        self.net_d.load_state_dict(to_state(variables), strict=True)

    def g_turn(self, current_iter):
        """Whether ``net_g`` steps in iteration ``current_iter``."""
        return current_iter % self.net_d_iters == 0 \
            and current_iter > self.net_d_init_iters

    def update_learning_rate(self, current_iter, warmup_iter=-1):
        """``net_g``'s schedule at its count of updates so far (the turns
        before ``current_iter``), ``net_d``'s at the iteration."""
        done, k = current_iter - 1, self.net_d_iters
        g_updates = done // k - min(self.net_d_init_iters, done) // k
        self.schedulers[0].step(g_updates + 1)
        self.schedulers[1].step(current_iter)

    def _net_d_forward(self, img):
        """``net_d`` on NHWC images or clips (frames as a batch)."""
        return self.net_d(_frames_as_batch(img).permute(0, 3, 1, 2))

    def g_loss_keys(self):
        """The generator's terms, in the order :meth:`g_losses` gives
        them."""
        keys = ['l_g_pix'] if self.cri_pix is not None else []
        if self.cri_ldl is not None:
            keys.append('l_g_ldl')
        if self.cri_perceptual is not None:
            if self.cri_perceptual.perceptual_weight > 0:
                keys.append('l_g_percep')
            if self.cri_perceptual.style_weight > 0:
                keys.append('l_g_style')
        return keys + ['l_g_gan']

    def _train_step_inputs(self):
        """``(lq, gt_pix, gt_percep, gt_gan, gt_ldl)``: the input and the
        target of each term (module docstring); ``gt`` for every term
        here."""
        return self.lq, self.gt, self.gt, self.gt, self.gt

    def g_losses(self, output):
        """The generator's terms of ``output`` against their targets
        (:meth:`_train_step_inputs`), in the JAX step's order: pixel, LDL,
        perceptual and style, GAN; the discriminator's pass writes no
        running statistics."""
        lq, gt_pix, gt_percep, _, gt_ldl = self._train_step_inputs()
        terms = self.losses(output, gt_pix, gt_percep)
        losses = OrderedDict()
        if 'l_pix' in terms:
            losses['l_g_pix'] = terms.pop('l_pix')
        losses.update(self.ldl_loss(lq, output, gt_ldl))
        for key, value in terms.items():
            losses[key.replace('l_', 'l_g_', 1)] = value
        losses['l_g_gan'] = self.g_gan_loss(output)
        return losses

    def ldl_loss(self, lq, output, gt):
        """``{'l_g_ldl': ...}`` where ``train.ldl_opt`` is set, else empty
        (module docstring). A clip's frames count as a batch."""
        if self.cri_ldl is None:
            return {}
        with torch.no_grad():
            output_ema = self._run(self.net_g_ema, torch.float32, False, lq)
        output, gt, output_ema = (_frames_as_batch(x)
                                  for x in (output, gt, output_ema))
        weight = get_refined_artifact_map(gt, output, output_ema, 7)
        return {'l_g_ldl': self.cri_ldl(weight * output, weight * gt)}

    def g_gan_loss(self, output):
        """The generator's GAN term: ``output`` judged real; the
        discriminator's pass writes no running statistics."""
        with frozen_stats(self.net_d):
            return self.cri_gan(self._net_d_forward(output), True,
                                is_disc=False)

    def d_losses(self, fake):
        """The discriminator's terms on the real images (``gt_gan`` of
        :meth:`_train_step_inputs`, first) and ``fake``; the loss is
        ``l_d_real + l_d_fake``."""
        real_pred = self._net_d_forward(self._train_step_inputs()[3])
        fake_pred = self._net_d_forward(fake)
        return OrderedDict(
            l_d_real=self.cri_gan(real_pred, True, is_disc=True),
            l_d_fake=self.cri_gan(fake_pred, False, is_disc=True),
            out_d_real=real_pred.detach().mean(),
            out_d_fake=fake_pred.detach().mean())

    @staticmethod
    def d_total(d_losses):
        """The loss the discriminator steps on: ``l_d_real + l_d_fake``."""
        return d_losses['l_d_real'] + d_losses['l_d_fake']

    def optimize_parameters(self, current_iter):
        """One GAN step on the batch of :meth:`feed_data` at iteration
        ``current_iter`` (1 on the first; module docstring)."""
        if not self.is_train:
            raise RuntimeError('the model was built with is_train false')
        self.update_learning_rate(current_iter)
        g_turn = self.g_turn(current_iter)
        with torch.set_grad_enabled(g_turn):
            output = self._run(self.net_g, torch.float32, False, self.lq)
        if g_turn:
            self.optimizer_g.zero_grad(set_to_none=True)
            losses = self.g_losses(output)
            sum(losses.values()).backward()
            if self.frozen(current_iter):
                for name, param in self.get_bare_model(
                        self.net_g).named_parameters():
                    if not self.freeze_keep(name):
                        param.grad.zero_()
            self.optimizer_g.step()
        else:
            zero = torch.zeros((), device=self.device)
            losses = OrderedDict((k, zero) for k in self.g_loss_keys())

        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad(set_to_none=True)
        d_losses = self.d_losses(output.detach())
        self.d_total(d_losses).backward()
        if self.opt.get('dist'):
            all_reduce_grads_mean(self.net_d.parameters())
        self.optimizer_d.step()
        self.net_d.requires_grad_(False)
        losses.update(d_losses)

        if self.net_g_ema is not None:
            self.ema_update()
        self.log_dict = self.reduce_loss_dict(OrderedDict(
            (k, v.detach()) for k, v in losses.items()))

    def save(self, epoch, current_iter):
        """``net_g_<iter>.pth`` (with ``params_ema`` where there is an
        EMA), ``net_d_<iter>.pth`` and ``<iter>.state``."""
        if self.net_g_ema is not None:
            self.save_network([self.net_g, self.net_g_ema], 'net_g',
                              current_iter,
                              param_key=['params', 'params_ema'])
        else:
            self.save_network(self.net_g, 'net_g', current_iter)
        self.save_network(self.net_d, 'net_d', current_iter)
        self.save_training_state(epoch, current_iter)
