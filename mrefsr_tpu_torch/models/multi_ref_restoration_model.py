"""Multi-reference restoration model: eval, the pixel phase of training
and the WGAN-GP phase after it (port of
``mrefsr_tpu/models/multi_ref_restoration_model.py``).

Three nets: the contrastive VGG16 extractor (``network_extractor``), the
correspondence generator (``network_map``: patch matching + VGG19 ref
features) and the MRAPA restoration net (``network_g``). A request goes
``feed_data`` -> ``test`` -> ``get_current_visuals`` and a training step
``feed_data`` -> ``optimize_parameters`` -> ``get_current_log``, with the
JAX model's sample dict: NHWC ``img_in_lq``, ``img_in_up``, ``img_in`` and
``img_ref_list`` of shape (B, T, H, W, 3). Validation (``validation``)
un-pads each output and sums PSNR, PSNR_Y and SSIM_Y, sharded over the
ranks when ``opt['dist']``.

``train.mixed_precision`` and ``val.mixed_precision`` (``bfloat16``) carry
the JAX package's bf16 policy over, cast for cast (its
multi_ref_restoration_model.py:342-403, 756-766), without
``torch.autocast``, whose per-op lists differ: the frozen extractor's and
map's parameters, ``img_in_up``, the refs and ``lq`` are cast to bf16, and
so are net_g's parameters, by a differentiable cast inside the loss in
training (the gradients reach the f32 master parameters) and once per
weights at eval. The output goes back to f32 before the loss, the un-pad
and the metrics. Gradients, Adam's state, the master parameters and the
checkpoints stay f32. What the JAX package's dtype promotion makes f32
stays f32 here too: the flows and pre-offsets, and the offsets and flows of
DynAgg / FlowAgg (a bf16 residual plus an f32 pre-offset).

The GAN phase runs in f32 whatever ``train.mixed_precision`` says, as the
JAX package's GAN step casts nothing (its :562, :598): a shipped GAN YAML
with ``mixed_precision: bfloat16`` trains bf16 pixel steps up to
``net_g_pretrain_steps``, then f32 GAN steps.
"""
import logging
import os.path as osp
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.archs.vgg_arch import vgg_rename
from mrefsr_tpu_torch.convert import (drop_buffer_keys, state_dict_from_flax,
                                      state_dict_from_flax_variables)
from mrefsr_tpu_torch.data.loader import default_collate
from mrefsr_tpu_torch.losses import legacy_losses
from mrefsr_tpu_torch.metrics import calculate_psnr, calculate_ssim
from mrefsr_tpu_torch.parallel import data_parallel
from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d, frozen_stats
from mrefsr_tpu_torch.parallel.ddp import (all_reduce_grads_mean,
                                           broadcast_module)
from mrefsr_tpu_torch.utils import imwrite, tensor2img
from mrefsr_tpu_torch.utils.dist_util import get_dist_info
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .base_model import BaseModel, compute_dtype

# the Adam groups of net_g, in the order of the learning-rate log
PARAM_GROUPS = ('g', 'offset', 'relu3_offset', 'relu2_offset')
def param_group_of(name):
    """The Adam group of a net_g parameter, by its name (reference
    multi_ref_restoration_model.py:60-89): the offset convs of the small
    (relu3_1) and medium (relu2_1) scales train at their own rates."""
    if 'offset' in name:
        if 'small' in name:
            return 'relu3_offset'
        if 'medium' in name:
            return 'relu2_offset'
        return 'offset'
    return 'g'


@MODEL_REGISTRY.register()
class MultiRefRestorationModel(BaseModel):
    """The LMR multi-reference model: eval forward, pixel-loss training and
the WGAN-GP phase.

    Weights come from ``path.pretrain_network_g``,
    ``path.pretrain_network_feature_extractor`` and
    ``path.vgg_pretrain_path`` where those keys name a file (a named file
    that does not exist raises), from :meth:`load_from_flax`, and
    otherwise from ``manual_seed`` through a ``torch.Generator``. Runs on
    ``device`` (``cuda`` unless named).

    With ``is_train`` the extractor and the map stay frozen and run under
    ``torch.no_grad()``; ``net_g`` trains with f32 master parameters and
    one Adam of four parameter groups, its forward in f32 or, with
    ``train.mixed_precision: bfloat16``, in bf16 (``val.mixed_precision``
    likewise for ``test``; see the module docstring). With ``opt['dist']``
    (every rank a process of ``init_dist``) ``net_g`` trains in
    ``DistributedDataParallel``, each rank on its own batch, and
    validation is sharded over the ranks.

    With ``network_d`` (an ``ImageDiscriminator``) and ``train.gan_type``,
    iterations after ``net_g_pretrain_steps`` are GAN steps
    (:meth:`_optimize_gan`): a discriminator step on ``l_d_real +
    l_d_fake + l_grad_penalty``, then, on ``g_turn``, a generator step on
    the pixel, perceptual, style and GAN losses against the updated
    discriminator; both in f32 (module docstring). ``net_d`` trains with
    its own Adam; ``save`` writes ``net_d_<iter>.pth`` beside
    ``net_g_<iter>.pth``, and the ``.state`` holds both optimizers and
    both schedulers, G then D.
    """

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.eval_dtype = compute_dtype(opt, 'val')
        self.train_dtype = compute_dtype(opt, 'train') if self.is_train \
            else torch.float32
        # f32 by default, as the JAX package's. cuDNN runs f32
        # convolutions in TF32 (about three decimal digits) unless told
        # otherwise, so both TF32 switches are set off here, and cuBLAS
        # may reduce bf16 products partly in bf16, where the JAX package
        # sums in f32 (dcn.py:144, correlation.py:86); the switches are
        # process-wide.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

        with torch.device('meta'):
            self.net_extractor = build_network(opt['network_extractor'])
            self.net_map = build_network(opt['network_map'])
            self.net_g = build_network(opt['network_g'])
            # the discriminator trains only: a test run does not make it
            self.net_d = build_network(opt['network_d']) \
                if self.is_train and opt.get('network_d') else None
        seed = opt.get('manual_seed') or 0
        generator = torch.Generator().manual_seed(seed)
        for net in self._nets():
            net.to_empty(device=self.device)
            net.init_weights(generator)
            net.eval().requires_grad_(False)
        if self.net_d is not None:
            # always in training mode, as the reference trains it: its
            # norms use their batch's statistics
            self.net_d.to_empty(device=self.device)
            self.net_d.init_weights(generator)
            self.net_d.train().requires_grad_(False)
        self.penalty_seed = seed
        self._load_pretrained()
        self._to_channels_last()
        self.output = None
        if self.is_train:
            self.init_training_settings()
            if opt.get('dist'):
                self.net_g = data_parallel(self.net_g, self.device)
                if self.net_d is not None:
                    broadcast_module(self.net_d)
                    for m in self.net_d.modules():
                        if isinstance(m, BatchNorm2d):
                            m.sync = True

    def _nets(self):
        return (self.net_extractor, self.net_map,
                self.get_bare_model(self.net_g))

    def _to_channels_last(self):
        for net in self._nets() + ((self.net_d,) if self.net_d else ()):
            net.to(memory_format=torch.channels_last)

    def _load_pretrained(self):
        """The weights ``path`` names (a named file that is not on disk
        raises: :meth:`named_file`)."""
        path = self.opt.get('path') or {}
        strict = path.get('strict_load', True)
        named = self.named_file
        file = named('pretrain_network_feature_extractor')
        if file:
            self.load_network(self.net_extractor, file, strict,
                              rename=drop_buffer_keys)
        file = named('vgg_pretrain_path')
        if file:
            rename = vgg_rename(self.net_map.vgg_type)
            # torchvision's VGG goes deeper than the taps the map uses
            own = self.net_map.state_dict()

            def map_key(key):
                key = rename(key)
                key = key and f'vgg.{key}'
                return key if key in own else None

            self.load_network(self.net_map, file, True, param_key=None,
                              rename=map_key)
        file = named('pretrain_network_g')
        if file:
            self.load_network(self.get_bare_model(self.net_g), file, strict)
        file = named('pretrain_network_d')
        if file and self.net_d is not None:
            self.load_network(self.net_d, file, strict)

    def load_from_flax(self, vars_ex, vars_map, vars_g, vars_d=None,
                       vgg=None, vgg_style=None):
        """Take the JAX package's flax variables of the three nets, and
        where given the discriminator's (``params`` and ``batch_stats``)
        and the perceptual and style losses' VGG towers'."""
        for net, variables in zip(self._nets(), (vars_ex, vars_map, vars_g)):
            net.load_state_dict(state_dict_from_flax(variables['params']),
                                strict=True)
        if vars_d is not None:
            self.net_d.load_state_dict(
                state_dict_from_flax_variables(vars_d), strict=True)
        for loss, variables in ((getattr(self, 'cri_perceptual', None), vgg),
                                (getattr(self, 'cri_style', None),
                                 vgg_style)):
            if variables is not None:
                loss.vgg.load_state_dict(
                    state_dict_from_flax(variables['params']), strict=True)
        self._to_channels_last()

    # the batch keys the model reads, which the device prefetchers move
    # (the refs' lq and up stacks stay on the host: this model does not
    # read them, and they would triple the bytes copied)
    device_input_keys = ('img_in', 'img_in_lq', 'img_in_up', 'img_ref_list')

    def feed_data(self, data):
        self.img_in_lq = self._tensor(data['img_in_lq'])
        self.img_ref_list = self._tensor(data['img_ref_list'])
        self.match_img_in = self._tensor(data['img_in_up'])
        self.gt = self._tensor(data['img_in']) if 'img_in' in data else None

    # ------------------------------------------------------------- training
    def init_training_settings(self):
        """The losses, the four-group Adam of ``net_g``, ``net_d``'s Adam
        and their schedules (JAX package multi_ref_restoration_model.py:
        76-192). ``steps_per_dispatch`` is accepted: steps run one at a
        time, which gives the same trajectory. A zero ``pixel_weight``
        drops the pixel loss, which only a run without pixel steps can
        do."""
        train_opt = self.opt['train']
        self.cri_pix = getattr(legacy_losses, train_opt['pixel_criterion'])(
            loss_weight=train_opt['pixel_weight'], reduction='mean') \
            if train_opt['pixel_weight'] > 0 else None
        # the VGG towers of the perceptual and style losses, made on meta
        # and given their weights here (load_vgg_weights)
        self.cri_perceptual = self.cri_style = None
        for attr, key in (('cri_perceptual', 'perceptual_opt'),
                          ('cri_style', 'style_opt')):
            if train_opt.get(key):
                with torch.device('meta'):
                    loss = legacy_losses.PerceptualLoss(**train_opt[key])
                self.load_vgg_weights(loss.vgg)
                loss.vgg.to(memory_format=torch.channels_last)
                setattr(self, attr, loss)
        self.cri_gan = self.cri_grad_penalty = None
        if train_opt.get('gan_type'):
            self.cri_gan = legacy_losses.GANLoss(
                train_opt['gan_type'], real_label_val=1.0,
                fake_label_val=0.0, loss_weight=train_opt['gan_weight'])
            if train_opt.get('grad_penalty_weight', 0) > 0:
                self.cri_grad_penalty = legacy_losses.GradientPenaltyLoss(
                    loss_weight=train_opt['grad_penalty_weight'])
        self.net_g_pretrain_steps = train_opt.get('net_g_pretrain_steps', 0)
        self.net_d_steps = train_opt.get('net_d_steps', 1)
        self.net_d_init_steps = train_opt.get('net_d_init_steps', 0)
        if self.net_d is not None and self.cri_gan is None:
            raise ValueError('network_d trains against train.gan_type, '
                             'which is unset')
        if self.cri_pix is None and (self.net_d is None
                                     or self.net_g_pretrain_steps > 0):
            raise ValueError('the pixel steps need train.pixel_weight > 0')

        self.net_g.train().requires_grad_(True)
        groups = {label: [] for label in PARAM_GROUPS}
        for name, param in self.net_g.named_parameters():
            groups[param_group_of(name)].append(param)
        lrs = {'g': train_opt['lr_g'], 'offset': train_opt['lr_offset'],
               'relu3_offset': train_opt['lr_relu3_offset'],
               'relu2_offset': train_opt['lr_relu2_offset']}
        # torch's Adam decays as the reference does: coupled L2
        self.optimizer_g = torch.optim.Adam(
            [{'params': groups[label], 'lr': lrs[label]}
             for label in PARAM_GROUPS],
            weight_decay=train_opt.get('weight_decay_g', 0),
            betas=tuple(train_opt.get('beta_g', (0.9, 0.999))))
        self.optimizers = [self.optimizer_g]
        if self.net_d is not None:
            # optax.adam, as the JAX package's: no weight decay
            self.optimizer_d = torch.optim.Adam(
                self.net_d.parameters(), lr=train_opt['lr_d'],
                betas=tuple(train_opt.get('beta_d', (0.9, 0.999))))
            self.optimizers.append(self.optimizer_d)
        self.setup_schedulers()

    def _gan_step(self, step):
        """Whether iteration ``step`` is a GAN step, and if so whether the
        generator updates in it (``g_turn``, JAX package :686-688)."""
        k = step - self.net_g_pretrain_steps
        if self.net_d is None or k <= 0:
            return False, False
        return True, k % self.net_d_steps == 0 and k > self.net_d_init_steps

    def update_learning_rate(self, current_iter, warmup_iter=-1):
        """Set the rates iteration ``current_iter`` trains with. As the JAX
        package's optax schedules, each optimizer's schedule runs on its
        own count of updates: ``net_g``'s misses the GAN steps without a
        ``g_turn``, ``net_d``'s starts at the first GAN step. In a run
        without a discriminator both are the iteration."""
        pretrain = self.net_g_pretrain_steps
        done = current_iter - 1 - pretrain   # GAN steps before this one
        g_updates = current_iter - 1
        if self.net_d is not None and done > 0:
            skipped_gan = done - (max(done // self.net_d_steps
                                      - self.net_d_init_steps
                                      // self.net_d_steps, 0))
            g_updates -= skipped_gan
        self.schedulers[0].step(g_updates + 1)
        if self.net_d is not None and current_iter > pretrain:
            self.schedulers[1].step(done + 1)

    def optimize_parameters(self, step):
        """One training step on the batch of :meth:`feed_data`, at
        iteration ``step`` (1 on the first): a pixel step of ``net_g``, or
        past ``net_g_pretrain_steps`` with a discriminator a GAN step."""
        if not self.is_train:
            raise RuntimeError('the model was built with is_train false')
        self.update_learning_rate(step)
        if self._gan_step(step)[0]:
            self._optimize_gan(step)
            return
        self.optimizer_g.zero_grad(set_to_none=True)
        l_pix = self.cri_pix(self._forward(
            self.match_img_in, self.img_ref_list, self.img_in_lq), self.gt)
        l_pix.backward()
        self.optimizer_g.step()
        self.log_dict = self.reduce_loss_dict(
            OrderedDict(l_pix=l_pix.detach()))

    def _net_d_forward(self, img):
        """``net_d`` on an NHWC image -> (B, 1, 1, 1)."""
        return self.net_d(img.permute(0, 3, 1, 2))

    def penalty_alpha(self, batch, step):
        """This rank's interpolation weights (``batch``, 1, 1, 1) of
        iteration ``step``'s gradient penalty: its rows of one U[0, 1)
        draw for the global batch, from a CPU generator seeded by
        ``manual_seed`` and ``step``. So a run of several ranks
        interpolates as one process on the global batch does, and a
        resumed run as the unbroken one, with no generator state in the
        checkpoint. (The JAX package splits a key per step from its
        model's stream; the values differ, the law is the same.)"""
        rank, world = get_dist_info() if self.opt.get('dist') else (0, 1)
        generator = torch.Generator().manual_seed(
            (self.penalty_seed * 1_000_003 + step) % 2 ** 63)
        alpha = torch.rand((batch * world, 1, 1, 1), generator=generator)
        return alpha[rank * batch:(rank + 1) * batch]

    def d_losses(self, fake, alpha):
        """The discriminator step's terms on the batch's ``gt`` (real) and
        ``fake``: ``l_d_real``, ``l_d_fake``, ``out_d_real``, ``out_d_fake``
        and, with a penalty, ``l_grad_penalty`` at the interpolation
        weights ``alpha``, whose pass writes no running statistics. The
        loss is the sum of the ``l_`` terms."""
        cri_gan = self.cri_gan
        real_pred = self._net_d_forward(self.gt)
        fake_pred = self._net_d_forward(fake)
        losses = OrderedDict(l_d_real=cri_gan(real_pred, True, is_disc=True),
                             l_d_fake=cri_gan(fake_pred, False, is_disc=True),
                             out_d_real=real_pred.mean(),
                             out_d_fake=fake_pred.mean())
        if self.cri_grad_penalty is not None:
            with frozen_stats(self.net_d):
                losses['l_grad_penalty'] = self.cri_grad_penalty(
                    self._net_d_forward, self.gt, fake, alpha=alpha)
        return losses

    def _g_loss_keys(self):
        """The generator step's terms, in the order :meth:`g_losses` gives
        them."""
        keys = ['l_g_pix'] if self.cri_pix is not None else []
        if self.cri_perceptual is not None \
                and self.cri_perceptual.perceptual_weight > 0:
            keys.append('l_g_percep')
        if self.cri_style is not None and self.cri_style.style_weight > 0:
            keys.append('l_g_style')
        return keys + ['l_g_gan']

    def g_losses(self, output):
        """The generator step's terms of ``output`` against the batch's
        ``gt``: pixel, perceptual, style and GAN (the discriminator's pass
        writes no running statistics); the loss is their sum."""
        keys = self._g_loss_keys()
        losses = OrderedDict()
        if 'l_g_pix' in keys:
            losses['l_g_pix'] = self.cri_pix(output, self.gt)
        if 'l_g_percep' in keys:
            losses['l_g_percep'] = self.cri_perceptual(output, self.gt)[0]
        if 'l_g_style' in keys:
            losses['l_g_style'] = self.cri_style(output, self.gt)[1]
        with frozen_stats(self.net_d):
            losses['l_g_gan'] = self.cri_gan(self._net_d_forward(output),
                                             True, is_disc=False)
        return losses

    def _optimize_gan(self, step):
        """One GAN step (JAX package :528-751), f32 throughout.

        ``net_g`` runs forward once: the discriminator step takes its
        output detached, and the generator step, on ``g_turn``,
        differentiates the same output (the JAX step runs the forward a
        second time inside its generator loss, at the same parameters,
        since the discriminator step does not touch them). The
        discriminator's norms write their running statistics in the real
        and the fake pass only; the penalty's pass and the generator
        step's normalise by their own batch and write nothing
        (:func:`~mrefsr_tpu_torch.parallel.batch_norm.frozen_stats`).
        Without ``g_turn`` the generator losses log as 0."""
        _, g_turn = self._gan_step(step)
        with torch.set_grad_enabled(g_turn):
            output = self._forward(self.match_img_in, self.img_ref_list,
                                   self.img_in_lq, dtype=torch.float32)
        fake = output.detach()

        # ---- the discriminator step (reference :219-242)
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad(set_to_none=True)
        losses = self.d_losses(fake, self.penalty_alpha(fake.shape[0], step))
        sum(v for k, v in losses.items() if k.startswith('l_')).backward()
        if self.opt.get('dist'):
            all_reduce_grads_mean(self.net_d.parameters())
        self.optimizer_d.step()
        self.net_d.requires_grad_(False)

        # ---- the generator step on g_turn (reference :244-279)
        if g_turn:
            self.optimizer_g.zero_grad(set_to_none=True)
            g_losses = self.g_losses(output)
            sum(g_losses.values()).backward()
            self.optimizer_g.step()
        else:
            zero = torch.zeros((), device=self.device)
            g_losses = OrderedDict((k, zero) for k in self._g_loss_keys())
        losses.update(g_losses)
        self.log_dict = self.reduce_loss_dict(OrderedDict(
            (k, v.detach()) for k, v in losses.items()))

    def optimize_parameters_wave(self, batches, first_iter):
        """Steps ``first_iter``, ``first_iter + 1``, ... on ``batches`` in
        turn, across the pixel -> GAN boundary too (the JAX package fuses
        them into one dispatch, :457-527; one at a time gives the same
        trajectory, docs/TPUDesign.md:58-66). The log holds the last
        step's losses."""
        for j, batch in enumerate(batches):
            self.feed_data(batch)
            self.optimize_parameters(first_iter + j)

    def save(self, epoch, current_iter):
        self.save_network(self.net_g, 'net_g', current_iter)
        if self.net_d is not None:
            self.save_network(self.net_d, 'net_d', current_iter)
        self.save_training_state(epoch, current_iter)

    # -------------------------------------------------------------- forward
    def _forward(self, match_img_in, refs, lq, net_g=None, dtype=None):
        """NHWC in, NHWC f32 out; the nets run NCHW in channels-last
        memory, which is what an NHWC tensor permuted to NCHW already is.
        The frozen extractor and map run without a graph. ``net_g`` is the
        training wrapper by default, ``dtype`` the training compute
        dtype."""
        dtype = self.train_dtype if dtype is None else dtype
        with torch.no_grad():
            pre_offset, img_ref_feat = self._ref_inputs(match_img_in, refs,
                                                        dtype)
        return self._net_g_forward(lq, pre_offset, img_ref_feat, net_g,
                                   dtype)

    def _net_g_forward(self, lq, pre_offset, img_ref_feat, net_g=None,
                       dtype=None, cached=False):
        """``net_g`` on NHWC ``lq`` (cast to ``dtype``) -> NHWC f32. At
        bf16 the parameters are cast copies: made anew, differentiable,
        unless ``cached`` (eval), then once per weights."""
        net_g = self.net_g if net_g is None else net_g
        dtype = self.train_dtype if dtype is None else dtype
        out = self._run(net_g, dtype, cached, lq.to(dtype).permute(0, 3, 1, 2),
                        pre_offset, img_ref_feat)
        return out.permute(0, 2, 3, 1).float()

    def _ref_inputs(self, match_img_in, refs, dtype=torch.float32):
        """``(pre_offset, img_ref_feat)`` of ``net_g`` (leaves (B, T, ...)
        for the MRAPA net) from the frozen nets in ``dtype`` (the
        pre-offsets are f32 whatever it is)."""
        b, t = refs.shape[:2]
        refs = refs.to(dtype).permute(0, 1, 4, 2, 3)      # (B, T, 3, H, W)
        d1, d2 = self._extract(
            dtype, match_img_in.to(dtype).permute(0, 3, 1, 2), refs)
        d1 = d1.unsqueeze(1).expand(-1, t, -1, -1, -1).flatten(0, 1)
        pre_offset, img_ref_feat = self._run(
            self.net_map, dtype, True,
            {'dense_features1': d1, 'dense_features2': d2.flatten(0, 1)},
            refs.flatten(0, 1))
        pre_offset = {k: v.unflatten(0, (b, t)) for k, v in pre_offset.items()}
        img_ref_feat = {k: v.unflatten(0, (b, t))
                        for k, v in img_ref_feat.items()}
        return self._net_g_ref_inputs(pre_offset, img_ref_feat)

    # the single-ref model's shape hooks (JAX package :287-306)
    def _extract(self, dtype, match_img_in, refs):
        """The extractor on the NCHW input and the (B, T, 3, H, W) refs:
        ``(d1 (B, C, h, w), d2 (B, T, C, h, w))``."""
        feats = self._run(self.net_extractor, dtype, True, match_img_in, refs)
        return feats['dense_features1'], feats['dense_features2']

    def _net_g_ref_inputs(self, pre_offset, img_ref_feat):
        """The map's (B, T, ...) outputs as ``net_g`` takes them: as they
        are for the MRAPA net."""
        return pre_offset, img_ref_feat

    def test(self):
        """The eval forward in ``val.mixed_precision``'s dtype, through the
        bare ``net_g``: it runs no collective, so ranks may answer
        different numbers of requests. ``self.output`` is f32."""
        dtype = self.eval_dtype
        with torch.inference_mode():
            pre_offset, img_ref_feat = self._ref_inputs(
                self.match_img_in, self.img_ref_list, dtype)
            self.output = self._net_g_forward(
                self.img_in_lq, pre_offset, img_ref_feat,
                self.get_bare_model(self.net_g), dtype, cached=True)

    def get_current_visuals(self):
        """``{'img_in_lq', 'rlt', 'gt'}`` as NHWC float32 numpy arrays."""
        out = OrderedDict()
        out['img_in_lq'] = self.img_in_lq.cpu().numpy()
        out['rlt'] = self.output.cpu().numpy()
        if self.gt is not None:
            out['gt'] = self.gt.cpu().numpy()
        return out

    # ----------------------------------------------------------- validation
    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        """Image-sharded validation (JAX package :802-836): rank ``r``
        evaluates images ``r::world`` and the metric sums are added over
        the ranks, so every rank ends with the whole set's averages in
        ``metric_results``; rank 0 logs them. The reference validated on
        rank 0 alone. Collective: every rank calls it. ``save_img`` writes
        each rank's own images."""
        rank, world = get_dist_info()
        sums = self._validate_images(dataloader, current_iter, save_img,
                                     rank=rank, world=world)
        if world > 1:
            # on this rank's device: NCCL reduces no CPU tensor
            total = torch.tensor(sums, dtype=torch.float64,
                                 device=self.device)
            dist.all_reduce(total)
            sums = total.cpu().numpy()
        self._finalize_validation(sums, dataloader.dataset.opt['name'],
                                  current_iter, tb_logger, log=rank == 0)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """CUFED5-style validation on this process: un-pad, PSNR (RGB),
        PSNR_Y and SSIM_Y at ``crop_border`` (JAX package :838-844)."""
        sums = self._validate_images(dataloader, current_iter, save_img)
        self._finalize_validation(sums, dataloader.dataset.opt['name'],
                                  current_iter, tb_logger)

    def _validate_images(self, dataloader, current_iter, save_img,
                         rank=0, world=1):
        """Evaluate images ``rank::world`` of the loader's dataset and
        return the sums ``[psnr, psnr_y, ssim_y, count]`` as float64 (JAX
        package :846-924). A sharded run indexes the dataset itself, so
        no rank decodes another's images; it takes a loader of batch 1
        without a sampler, which is what validation loaders are."""
        sums = np.zeros(4, np.float64)
        dataset_name = dataloader.dataset.opt['name']
        if world > 1:
            if getattr(dataloader, 'sampler', None) is not None \
                    or getattr(dataloader, 'batch_size', 1) not in (None, 1):
                raise ValueError('sharded validation indexes the dataset '
                                 'itself: it takes a loader of batch 1 '
                                 'without a sampler')
            dataset = dataloader.dataset
            collate = getattr(dataloader, 'collate_fn', None) \
                or default_collate
            batches = (collate([dataset[i]])
                       for i in range(rank, len(dataset), world))
        else:
            batches = dataloader
        crop_border = self.opt['crop_border']
        for val_data in batches:
            lq_path = val_data['lq_path']
            lq_path = lq_path[0] if isinstance(lq_path, list) else lq_path
            img_name = osp.splitext(osp.basename(lq_path))[0]
            self.feed_data(val_data)
            self.test()
            visuals = self.get_current_visuals()
            sr_img = tensor2img(visuals['rlt'])
            gt_img = tensor2img(visuals['gt'])
            if 'padding' in val_data:
                height, width = np.asarray(val_data['original_size'])[0]
                sr_img = sr_img[:int(height), :int(width)]
            if save_img:
                imwrite(sr_img, self._val_image_path(img_name, dataset_name,
                                                     current_iter))
            sums += (calculate_psnr(sr_img, gt_img, crop_border=crop_border),
                     calculate_psnr(sr_img, gt_img, crop_border=crop_border,
                                    test_y_channel=True),
                     calculate_ssim(sr_img, gt_img, crop_border=crop_border,
                                    test_y_channel=True),
                     1)
        return sums

    def _val_image_path(self, img_name, dataset_name, current_iter):
        visualization = self.opt['path']['visualization']
        if self.is_train:
            return osp.join(visualization, img_name,
                            f'{img_name}_{current_iter}.png')
        suffix = f"_{self.opt['suffix']}" if self.opt.get('suffix') else ''
        return osp.join(visualization, dataset_name,
                        f"{img_name}_{self.opt['name']}{suffix}.png")

    def _finalize_validation(self, sums, dataset_name, current_iter,
                             tb_logger, log=True):
        """``metric_results`` from the sums (JAX package :926-942)."""
        if sums[3] <= 0:
            return
        avg_psnr, avg_psnr_y, avg_ssim_y = (sums[:3] / sums[3]).tolist()
        self.metric_results = {'psnr': avg_psnr, 'psnr_y': avg_psnr_y,
                               'ssim_y': avg_ssim_y}
        if not log:
            return
        logging.getLogger(__name__).info(
            f'# Validation {dataset_name} # PSNR: {avg_psnr:.4e} '
            f'# PSNR_Y: {avg_psnr_y:.4e} # SSIM_Y: {avg_ssim_y:.4e}.')
        if tb_logger:
            for key, value in self.metric_results.items():
                tb_logger.add_scalar(key, value, current_iter)
