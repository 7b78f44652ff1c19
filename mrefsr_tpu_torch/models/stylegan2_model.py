"""StyleGAN2 training strategy and sampling (port of
``mrefsr_tpu/models/stylegan2_model.py``; reference
basicsr/models/stylegan2_model.py:18-283).

Non-saturating logistic GAN with lazy regularization: R1 on the
discriminator every ``net_d_reg_every`` steps and the path-length penalty
on the generator every ``net_g_reg_every`` steps. As in the JAX package,
each net takes one optimizer step per iteration on its loss with the
penalty added (the reference steps the penalties apart). Both penalties
differentiate a gradient again: ``upfirdn2d`` and ``fused_leaky_relu`` are
differentiable to second order on the card as on the CPU.

A training step goes ``feed_data({'gt': NHWC images in [-1, 1]})`` ->
``optimize_parameters(current_iter)`` -> ``get_current_log()``; sampling
goes ``test()`` -> ``output`` (NHWC) or ``nondist_validation``. The nets
themselves are NCHW. f32 throughout, TF32 off.

Randomness is the model's own: styles, injected noise and the path
penalty's noise come from a ``torch.Generator`` on the model's device
seeded with ``manual_seed``, the style-mixing coin and the crossover index
from a ``random.Random`` with the same seed (the JAX model uses the global
``random`` module, in the same order: coin, then index). The fixed
validation sample is drawn on the CPU from a ``torch.Generator`` seeded
2020: the same on every device, but other numbers than the JAX model's
``jax.random.PRNGKey(2020)``, as the two libraries' generators differ.
"""
import os
import random
from collections import OrderedDict
from copy import deepcopy

import torch

from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.convert import load_stylegan2_from_flax
from mrefsr_tpu_torch.losses import (build_loss, g_path_regularize,
                                     r1_penalty)
from mrefsr_tpu_torch.utils import imwrite, tensor2img
from mrefsr_tpu_torch.utils.dist_util import get_dist_info
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .base_model import BaseModel

EMA_DECAY = 0.5 ** (32 / (10 * 1000))


@MODEL_REGISTRY.register()
class StyleGAN2Model(BaseModel):
    """StyleGAN2 model. Weights come from ``path.pretrain_network_g`` /
    ``path.pretrain_network_d`` where those files are named, from
    :meth:`load_from_flax`, and otherwise from ``manual_seed``. Runs on
    ``device`` (``cuda`` unless named). Its validation samples the fixed
    codes and takes no data (:attr:`validates_without_data`)."""

    validates_without_data = True

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        # f32, as the JAX package's default is: cuDNN would run f32
        # convolutions in TF32 unless told otherwise (process-wide)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        seed = opt.get('manual_seed') or 0
        self._init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.rng = random.Random(seed)

        self.num_style_feat = opt['network_g']['num_style_feat']
        self.net_g = self._build_network(opt['network_g'])
        path = opt.get('path') or {}
        if path.get('pretrain_network_g'):
            self.load_network(self.net_g, path['pretrain_network_g'],
                              path.get('strict_load_g', True),
                              path.get('param_key_g', 'params'))
        num_val_samples = (opt.get('val') or {}).get('num_val_samples', 16)
        self.fixed_sample = torch.randn(
            (num_val_samples, self.num_style_feat),
            generator=torch.Generator().manual_seed(2020)).to(self.device)
        self.mean_path_length = torch.zeros((), device=self.device)
        self.output = None
        if self.is_train:
            self.init_training_settings()
        else:
            self.net_g_ema = self.net_g.eval().requires_grad_(False)

    def _build_network(self, net_opt):
        with torch.device('meta'):
            net = build_network(net_opt)
        net.to_empty(device=self.device)
        net.init_weights(self._init_generator)
        return net

    def init_training_settings(self):
        train_opt = self.opt['train']
        path = self.opt.get('path') or {}
        self.net_g_ema = deepcopy(self.net_g).eval().requires_grad_(False)
        if path.get('pretrain_network_g'):
            # a file without params_ema gives its params
            self.load_network(self.net_g_ema, path['pretrain_network_g'],
                              True, 'params_ema')
        self.net_d = self._build_network(self.opt['network_d'])
        if path.get('pretrain_network_d'):
            self.load_network(self.net_d, path['pretrain_network_d'],
                              path.get('strict_load_d', True),
                              path.get('param_key_d', 'params'))
        self.net_g.train()
        self.net_d.train()
        self.cri_gan = build_loss(train_opt['gan_opt'])
        self.r1_reg_weight = train_opt['r1_reg_weight']
        self.path_reg_weight = train_opt['path_reg_weight']
        self.net_g_reg_every = train_opt['net_g_reg_every']
        self.net_d_reg_every = train_opt['net_d_reg_every']
        self.mixing_prob = train_opt['mixing_prob']
        self.path_batch_shrink = train_opt.get('path_batch_shrink', 2)
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self):
        """Adam scaled for lazy regularization (reference :88-168): with a
        penalty every ``k`` steps, ``lr * c`` and ``betas ** c`` for
        ``c = k / (k + 1)``."""
        train_opt = self.opt['train']
        self.optimizers = []
        for net, every, key in ((self.net_g, self.net_g_reg_every, 'optim_g'),
                                (self.net_d, self.net_d_reg_every,
                                 'optim_d')):
            ratio = every / (every + 1)
            self.optimizers.append(torch.optim.Adam(
                net.parameters(), lr=train_opt[key]['lr'] * ratio,
                betas=(0 ** ratio, 0.99 ** ratio)))
        self.optimizer_g, self.optimizer_d = self.optimizers

    def load_from_flax(self, params_g, params_d=None, params_g_ema=None):
        """Take the JAX package's flax parameters: the generator's, the
        discriminator's and the EMA generator's (``params_g`` again where
        none is given)."""
        load_stylegan2_from_flax(self.net_g, params_g)
        if self.is_train:
            load_stylegan2_from_flax(
                self.net_g_ema,
                params_g if params_g_ema is None else params_g_ema)
            if params_d is not None:
                load_stylegan2_from_flax(self.net_d, params_d)

    def feed_data(self, data):
        """``data['gt']``: real images, (B, H, W, 3) in [-1, 1]."""
        real = torch.as_tensor(data['gt'], dtype=torch.float32,
                               device=self.device)
        self.real_img = real.permute(0, 3, 1, 2).contiguous()

    # ----------------------------------------------------------------- step
    def make_styles(self, batch, mixing):
        """One style code per sample, or two for style mixing."""
        return [torch.randn((batch, self.num_style_feat),
                            generator=self.generator, device=self.device)
                for _ in range(2 if mixing else 1)]

    def d_loss(self, real_img, fake_img, do_r1):
        """The discriminator's loss on NCHW real and (detached) fake
        images, with ``r1_reg_weight / 2 * R1 * net_d_reg_every`` added
        where ``do_r1``. Returns ``(l_d, log)``."""
        if do_r1:
            real_img = real_img.detach().requires_grad_(True)
        real_pred = self.net_d(real_img)
        fake_pred = self.net_d(fake_img)
        l_d = self.cri_gan(real_pred, True, is_disc=True) \
            + self.cri_gan(fake_pred, False, is_disc=True)
        if do_r1:
            l_d_r1 = r1_penalty(real_pred, real_img)
            l_d = l_d + (self.r1_reg_weight / 2 * l_d_r1
                         * self.net_d_reg_every)
        else:
            l_d_r1 = torch.zeros((), device=l_d.device)
        return l_d, OrderedDict(
            l_d=l_d.detach(), real_score=real_pred.detach().mean(),
            fake_score=fake_pred.detach().mean(), l_d_r1=l_d_r1.detach())

    def g_loss(self, styles, inject_index, noise=None, path=None):
        """The generator's loss for ``styles`` (crossover at
        ``inject_index``; injected ``noise`` given or drawn). ``path``
        adds ``path_reg_weight * net_g_reg_every *`` the path-length
        penalty: a dict with ``styles`` (the shrunk batch) and optionally
        ``noise`` (injected) and ``img_noise`` (the image weighting), each
        drawn where absent. Returns ``(l_g, log, mean_path_length)``."""
        fake_img, _ = self.net_g(styles, inject_index=inject_index,
                                 noise=noise, generator=self.generator)
        l_g = self.cri_gan(self.net_d(fake_img), True, is_disc=False)
        log = OrderedDict(l_g=l_g.detach())
        mean_path_length = self.mean_path_length
        if path is not None:
            fake_img, latents = self.net_g(
                path['styles'], inject_index=inject_index,
                noise=path.get('noise'), return_latents=True,
                generator=self.generator)
            l_g_path, path_length, mean_path_length = g_path_regularize(
                fake_img, latents, mean_path_length,
                noise=path.get('img_noise'), generator=self.generator)
            l_g = l_g + (self.path_reg_weight * self.net_g_reg_every
                         * l_g_path)
            # as in the JAX model, the logged l_g is without the penalty
            log.update(l_g_path=l_g_path.detach(), path_length=path_length)
        return l_g, log, mean_path_length

    def optimize_parameters(self, current_iter):
        """One alternating update at iteration ``current_iter`` (1 on the
        first) on the batch of :meth:`feed_data`: net_d, then net_g, then
        the EMA of net_g."""
        if not self.is_train:
            raise RuntimeError('the model was built with is_train false')
        mixing = self.rng.random() < self.mixing_prob
        inject_index = self.rng.randint(1, self.net_g.num_latent - 1)
        do_r1 = current_iter % self.net_d_reg_every == 0
        do_path = current_iter % self.net_g_reg_every == 0
        self.update_learning_rate(current_iter)
        batch = self.real_img.shape[0]

        # net_d, on a fake batch that carries no graph
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad(set_to_none=True)
        with torch.no_grad():
            fake_img, _ = self.net_g(self.make_styles(batch, mixing),
                                     inject_index=inject_index,
                                     generator=self.generator)
        l_d, log = self.d_loss(self.real_img, fake_img, do_r1)
        l_d.backward()
        self.optimizer_d.step()

        # net_g, through a frozen net_d
        self.net_d.requires_grad_(False)
        self.optimizer_g.zero_grad(set_to_none=True)
        styles = self.make_styles(batch, mixing)
        path = None
        if do_path:
            shrunk = max(1, batch // self.path_batch_shrink)
            path = {'styles': [s[:shrunk] for s in
                               self.make_styles(batch, mixing)]}
        l_g, log_g, self.mean_path_length = self.g_loss(
            styles, inject_index, path=path)
        l_g.backward()
        self.optimizer_g.step()
        log.update(log_g)

        self.ema_update(self.net_g_ema, self.net_g, EMA_DECAY)
        self.log_dict = log

    # ------------------------------------------------------------------ val
    def test(self):
        """Sample the fixed validation codes with the EMA generator;
        ``output`` is (num_val_samples, H, W, 3)."""
        with torch.inference_mode():
            output, _ = self.net_g_ema([self.fixed_sample],
                                       generator=self.generator)
        self.output = output.permute(0, 2, 3, 1)

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        """Rank 0 samples on its own."""
        if get_dist_info()[0] == 0:
            self.nondist_validation(dataloader, current_iter, tb_logger,
                                    save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """Write the sample grid of :meth:`test` as a PNG under
        ``path.visualization``."""
        if dataloader is not None:
            raise ValueError('Validation dataloader should be None.')
        self.test()
        result = tensor2img(self.output, min_max=(-1, 1))
        visualization = self.opt['path']['visualization']
        if self.is_train:
            save_img_path = os.path.join(visualization, 'train',
                                         f'train_{current_iter}.png')
        else:
            save_img_path = os.path.join(visualization, 'test',
                                         f'test_{self.opt["name"]}.png')
        imwrite(result, save_img_path)
        if tb_logger is not None:
            tb_logger.add_image('samples', result[:, :, ::-1] / 255.,
                                global_step=current_iter, dataformats='HWC')

    def save(self, epoch, current_iter):
        self.save_network([self.net_g, self.net_g_ema], 'net_g',
                          current_iter, param_key=['params', 'params_ema'])
        self.save_network(self.net_d, 'net_d', current_iter)
        self.save_training_state(epoch, current_iter)

    def get_current_visuals(self):
        return OrderedDict(result=self.output.cpu().numpy())
