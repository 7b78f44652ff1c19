"""SRModel: the training strategy of one restoration net on ``lq`` -> ``gt``
pairs, images or video clips (port of ``mrefsr_tpu/models/sr_model.py``,
the reference's basicsr/models/sr_model.py:15-231); the video models
subclass it.

Samples are the JAX package's: NHWC ``lq`` (B, H, W, 3) or clips
(B, T, H, W, 3), ``gt`` likewise. The net runs NCHW, a clip as
(B, T, 3, H, W); its output comes back NHWC. One step is ``feed_data`` ->
``optimize_parameters`` -> ``get_current_log``: the pixel and perceptual
losses, Adam (or AdamW, SGD) over the parameter groups of
:meth:`param_groups`, then the EMA ``ema = decay ema + (1 - decay) net``.

The JAX step's choices, carried over:

* **bf16** (``train.mixed_precision: bfloat16``): every f32 parameter and
  ``lq`` are cast to bf16 for the forward, by a differentiable cast, and
  the output back to f32 before the losses; gradients, Adam's state, the
  master parameters and the checkpoints stay f32. ``val.mixed_precision``
  casts the eval net once per weights. No ``torch.autocast``.
* **The freeze schedule** (``freeze_until``, ``freeze_keep``; EDVR's
  ``tsa_iter``, BasicVSR's ``fix_flow``): while ``current_iter <
  freeze_until`` the gradients of the parameters ``freeze_keep(name)``
  rejects are zeroed after the backward. They stay in the update, as
  optax keeps them: Adam's step count advances for every parameter, and
  with zero moments the frozen ones do not move. (``requires_grad_(False)``,
  the reference's way, would leave their ``grad`` None, Adam would skip
  them, and their step count would lag from the unfreeze on.)
* **EMA over all variables** (``train.ema_decay``): every parameter and
  every norm's running statistics; ``test`` then runs the EMA net.
* **Stochastic depth** (SwinIR's ``drop_path_rate``): the training forward
  draws its drop masks from a generator seeded by the step
  (:meth:`SRModel.stochastic_depth`); the GAN models' steps draw none, as
  the JAX package's GAN step passes no ``droppath`` key.

Weights come from ``manual_seed`` through a ``torch.Generator``, from
``path.pretrain_network_g`` (``param_key_g``, ``strict_load_g``: a
non-strict load keeps the seeded values of the keys the file lacks or
sizes otherwise, each with a log line, as the JAX package's
``_merge_loaded``: :meth:`BaseModel.load_network`), or from
:meth:`load_from_flax`.
"""
import contextlib
import copy
import logging
import os.path as osp
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.convert import load_from_flax
from mrefsr_tpu_torch.losses import build_loss
from mrefsr_tpu_torch.metrics import calculate_metric
from mrefsr_tpu_torch.parallel import data_parallel
from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d
from mrefsr_tpu_torch.utils import imwrite, tensor2img
from mrefsr_tpu_torch.utils.dist_util import get_dist_info
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .base_model import BaseModel, compute_dtype

logger = logging.getLogger(__name__)


def to_net_layout(x):
    """NHWC (B, H, W, C) -> NCHW; a clip (B, T, H, W, C) -> (B, T, C, H,
    W)."""
    return x.movedim(-1, -3)


def from_net_layout(y):
    """The inverse of :func:`to_net_layout`."""
    return y.movedim(-3, -1)


def ema_state(net):
    """The tensors the EMA follows: every parameter and every norm's
    running statistics (the JAX package's variables)."""
    out = dict(net.named_parameters())
    for name, module in net.named_modules():
        if isinstance(module, BatchNorm2d) or (
                isinstance(module, torch.nn.modules.batchnorm._NormBase)
                and module.track_running_stats):
            prefix = f'{name}.' if name else ''
            out[prefix + 'running_mean'] = module.running_mean
            out[prefix + 'running_var'] = module.running_var
    return out


def build_optimizer(groups, optim_opt):
    """The optimizer ``optim_opt['type']`` names over ``groups`` (JAX
    package base_model.py:115-149): ``Adam`` (``betas``, coupled
    ``weight_decay``, as torch's), ``AdamW`` (decoupled, default 1e-2) or
    ``SGD`` (``momentum``). The groups carry their base rates; other keys
    are ignored, as there."""
    opt = dict(optim_opt)
    kind = opt.pop('type')
    betas = tuple(opt.get('betas', (0.9, 0.999)))
    if kind == 'Adam':
        return torch.optim.Adam(groups, betas=betas,
                                weight_decay=opt.get('weight_decay', 0))
    if kind == 'AdamW':
        return torch.optim.AdamW(groups, betas=betas,
                                 weight_decay=opt.get('weight_decay', 1e-2))
    if kind == 'SGD':
        return torch.optim.SGD(groups, lr=groups[0]['lr'],
                               momentum=opt.get('momentum', 0))
    raise NotImplementedError(f'optimizer {kind} is not supported yet.')


@MODEL_REGISTRY.register()
class SRModel(BaseModel):
    """One ``network_g`` trained on ``lq`` -> ``gt`` (module docstring)."""

    device_input_keys = ('lq', 'gt')

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        # f32 as the JAX package's: no TF32 in cuDNN or cuBLAS, bf16
        # products summed in f32 (process-wide, as the multi-ref model)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        self.eval_dtype = compute_dtype(opt, 'val')
        self.train_dtype = compute_dtype(opt, 'train') if self.is_train \
            else torch.float32
        with torch.device('meta'):
            self.net_g = build_network(opt['network_g'])
        self.net_g.to_empty(device=self.device)
        self.net_g.init_weights(
            torch.Generator().manual_seed(opt.get('manual_seed') or 0))
        self.net_g.eval().requires_grad_(False)
        self.net_g_ema = None
        self.ema_decay = 0
        # the freeze schedule (module docstring)
        self.freeze_until = 0
        self.freeze_keep = None
        self.lq = self.gt = self.output = None
        self._load_pretrained()
        if self.is_train:
            self.init_training_settings()
            if opt.get('dist'):
                self.net_g = data_parallel(self.net_g, self.device)

    # -------------------------------------------------------------- weights
    def _load_pretrained(self):
        file = self.named_file('pretrain_network_g')
        if file:
            path = self.opt['path']
            self.load_network(self.net_g, file,
                              path.get('strict_load_g', True),
                              path.get('param_key_g', 'params'))

    def load_from_flax(self, variables):
        """Take the JAX package's flax variables of ``network_g``
        (``params``); the EMA starts from them, as the JAX model's."""
        net = load_from_flax(self.get_bare_model(self.net_g),
                             variables['params'])
        if self.net_g_ema is not None:
            self.net_g_ema.load_state_dict(net.state_dict())

    # ------------------------------------------------------------- training
    def init_training_settings(self):
        """The losses, the EMA, the optimizer over :meth:`param_groups` and
        its schedule (JAX package sr_model.py:50-83)."""
        train_opt = self.opt['train']
        self.ema_decay = train_opt.get('ema_decay', 0)
        net = self.net_g
        net.train().requires_grad_(True)
        if self.ema_decay > 0:
            logger.info(f'Use Exponential Moving Average with decay: '
                        f'{self.ema_decay}')
            self.net_g_ema = copy.deepcopy(net).eval().requires_grad_(False)
            file = self.named_file('pretrain_network_g')
            if file:
                self.load_network(self.net_g_ema, file, False, 'params_ema')
        self.cri_pix = build_loss(train_opt['pixel_opt']) \
            if train_opt.get('pixel_opt') else None
        self.cri_perceptual = None
        if train_opt.get('perceptual_opt'):
            with torch.device('meta'):
                self.cri_perceptual = build_loss(train_opt['perceptual_opt'])
            self.load_vgg_weights(self.cri_perceptual.vgg)
        self.check_losses()
        optim_opt = dict(train_opt['optim_g'])
        self.optimizer_g = build_optimizer(
            [{'params': params, 'lr': lr}
             for params, lr in self.param_groups(optim_opt.pop('lr'))],
            optim_opt)
        self.optimizers = [self.optimizer_g]
        self.setup_schedulers()

    def check_losses(self):
        """A pixel or a perceptual loss must train ``net_g``."""
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError('Both pixel and perceptual losses are None.')

    def param_groups(self, base_lr):
        """``[(parameters, base rate)]`` of the optimizer: one group."""
        return [(list(self.net_g.parameters()), base_lr)]

    def _labelled_groups(self, base_lr, label, lr, what):
        """Two groups: the parameters whose name holds ``label`` at ``lr``,
        the rest at ``base_lr`` (first, as the JAX package logs them)."""
        logger.info(f'{what} learning rate: {lr}.')
        named = list(self.net_g.named_parameters())
        return [([p for n, p in named if label not in n], base_lr),
                ([p for n, p in named if label in n], lr)]

    def feed_data(self, data):
        self.lq = self._tensor(data['lq'])
        self.gt = self._tensor(data['gt']) if 'gt' in data else None

    def _run(self, net, dtype, cached, x):
        """``net`` on the NHWC ``x`` in ``dtype`` -> NHWC float32, through
        :meth:`BaseModel._run`'s casts."""
        return from_net_layout(super()._run(
            net, dtype, cached, to_net_layout(x.to(dtype)))).float()

    def losses(self, output, gt, gt_percep=None):
        """The step's terms of ``output`` against ``gt``: ``l_pix``,
        ``l_percep``, ``l_style`` where configured (the last two against
        ``gt_percep`` where given); the loss is their sum. A clip's frames
        go through the VGG as a batch."""
        losses = OrderedDict()
        if self.cri_pix is not None:
            losses['l_pix'] = self.cri_pix(output, gt)
        if self.cri_perceptual is not None:
            flat = (lambda x: x.flatten(0, 1) if x.dim() == 5 else x)
            percep, style = self.cri_perceptual(
                flat(output), flat(gt if gt_percep is None else gt_percep))
            if percep is not None:
                losses['l_percep'] = percep
            if style is not None:
                losses['l_style'] = style
        return losses

    def frozen(self, current_iter):
        """Whether iteration ``current_iter`` (1 on the first) trains with
        the freeze: the JAX package's ``step_idx + 1 < until``."""
        return self.freeze_keep is not None \
            and current_iter < self.freeze_until

    def optimize_parameters(self, current_iter):
        """One step on the batch of :meth:`feed_data` at iteration
        ``current_iter`` (1 on the first)."""
        if not self.is_train:
            raise RuntimeError('the model was built with is_train false')
        self.update_learning_rate(current_iter)
        self.optimizer_g.zero_grad(set_to_none=True)
        with self.stochastic_depth(current_iter):
            output = self._run(self.net_g, self.train_dtype, False, self.lq)
        losses = self.losses(output, self.gt)
        sum(losses.values()).backward()
        if self.frozen(current_iter):
            for name, param in self.get_bare_model(
                    self.net_g).named_parameters():
                if not self.freeze_keep(name):
                    param.grad.zero_()
        self.optimizer_g.step()
        if self.net_g_ema is not None:
            self.ema_update()
        self.log_dict = self.reduce_loss_dict(OrderedDict(
            (k, v.detach()) for k, v in losses.items()))

    @contextlib.contextmanager
    def stochastic_depth(self, current_iter):
        """Within the block a net with a ``drop_path_rate`` (SwinIR) drops
        branches in training mode, drawing from a generator on the model's
        device seeded by ``manual_seed``, the rank and ``current_iter``:
        as the JAX step folds the step index into its ``droppath`` key, a
        resumed run draws the masks it would have drawn."""
        net = self.get_bare_model(self.net_g)
        if not getattr(net, 'drop_path_rate', 0):
            yield
            return
        seed = np.random.SeedSequence([self.opt.get('manual_seed') or 0,
                                       get_dist_info()[0], current_iter])
        net.generator = torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0]))
        try:
            yield
        finally:
            net.generator = None

    @torch.no_grad()
    def ema_update(self):
        """``ema = ema * decay + net * (1 - decay)``, the JAX step's
        expression (two products, one sum)."""
        decay = self.ema_decay
        net = ema_state(self.get_bare_model(self.net_g))
        for name, ema in ema_state(self.net_g_ema).items():
            ema.copy_(ema * decay + net[name] * (1 - decay))

    # ------------------------------------------------------------------ test
    def test(self):
        """The eval forward of ``lq`` through the EMA net where there is
        one, in ``val.mixed_precision``'s dtype. With ``val.pad_multiple``
        an image is reflect-padded at the bottom and right to a multiple
        of it and the output cropped back (JAX package sr_model.py:
        317-346). ``self.output`` is NHWC float32."""
        lq = self.lq
        pad_mult = (self.opt.get('val') or {}).get('pad_multiple', 0)
        if pad_mult:
            h, w = lq.shape[-3:-1]
            ph, pw = (-h) % pad_mult, (-w) % pad_mult
            if ph or pw:
                lq = F.pad(lq.permute(0, 3, 1, 2), (0, pw, 0, ph),
                           mode='reflect').permute(0, 2, 3, 1)
        out = self.eval_forward(lq)
        if pad_mult:
            scale = self.opt['scale']
            out = out[:, :self.lq.shape[1] * scale, :self.lq.shape[2] * scale]
        self.output = out

    def eval_forward(self, lq):
        """``lq`` through the EMA net where there is one, else the bare
        net, in ``val.mixed_precision``'s dtype, without a graph."""
        net = self.net_g_ema if self.net_g_ema is not None \
            else self.get_bare_model(self.net_g)
        with torch.inference_mode():
            return self._run(net, self.eval_dtype, True, lq)

    def get_current_visuals(self):
        """``{'lq', 'result', 'gt'}``: NHWC float32 tensors on the model's
        device (``tensor2img`` turns each into an image where it lies)."""
        out = OrderedDict(lq=self.lq.detach(), result=self.output)
        if self.gt is not None:
            out['gt'] = self.gt.detach()
        return out

    # ------------------------------------------------------------ validation
    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        """Rank 0 validates on its own, as the JAX package's."""
        if get_dist_info()[0] == 0:
            self.nondist_validation(dataloader, current_iter, tb_logger,
                                    save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """Each image of the loader through :meth:`test`, saved where
        ``save_img``, each metric of ``val.metrics`` averaged over the
        images (JAX package sr_model.py:357-413)."""
        dataset_name = dataloader.dataset.opt['name']
        metrics = self.opt['val'].get('metrics')
        if metrics is not None:
            self._initialize_best_metric_results(dataset_name)
            self.metric_results = {m: 0 for m in metrics}
        count = 0
        for val_data in dataloader:
            lq_path = val_data['lq_path']
            lq_path = lq_path[0] if isinstance(lq_path, list) else lq_path
            img_name = osp.splitext(osp.basename(lq_path))[0]
            self.feed_data(val_data)
            self.test()
            visuals = self.get_current_visuals()
            metric_data = {'img': tensor2img(visuals['result'])}
            if 'gt' in visuals:
                metric_data['img2'] = tensor2img(visuals['gt'])
            if save_img:
                imwrite(metric_data['img'], self._val_image_path(
                    img_name, dataset_name, current_iter))
            if metrics is not None:
                for name, opt_ in metrics.items():
                    self.metric_results[name] += calculate_metric(
                        metric_data, opt_)
            count += 1
        if metrics is not None and count:
            for metric in self.metric_results:
                self.metric_results[metric] /= count
                self._update_best_metric_result(
                    dataset_name, metric, self.metric_results[metric],
                    current_iter)
            self._log_validation_metric_values(current_iter, dataset_name,
                                               tb_logger)

    def _val_image_path(self, img_name, dataset_name, current_iter):
        visualization = self.opt['path']['visualization']
        if self.opt['is_train']:
            return osp.join(visualization, img_name,
                            f'{img_name}_{current_iter}.png')
        suffix = self.opt['val'].get('suffix') or self.opt['name']
        return osp.join(visualization, dataset_name,
                        f'{img_name}_{suffix}.png')

    def _log_validation_metric_values(self, current_iter, dataset_name,
                                      tb_logger):
        log_str = f'Validation {dataset_name}\n'
        for metric, value in self.metric_results.items():
            best = self.best_metric_results[dataset_name][metric]
            log_str += (f'\t # {metric}: {value:.4f}\tBest: '
                        f'{best["val"]:.4f} @ {best["iter"]} iter\n')
        logger.info(log_str)
        if tb_logger:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f'metrics/{dataset_name}/{metric}',
                                     value, current_iter)

    # ------------------------------------------------------------ save/load
    def save(self, epoch, current_iter):
        """``net_g_<iter>.pth`` (``params``, and ``params_ema`` with an
        EMA) and ``<iter>.state``."""
        if self.net_g_ema is not None:
            self.save_network([self.net_g, self.net_g_ema], 'net_g',
                              current_iter,
                              param_key=['params', 'params_ema'])
        else:
            self.save_network(self.net_g, 'net_g', current_iter)
        self.save_training_state(epoch, current_iter)
