"""Multi-reference restoration model: eval, and the pixel phase of
training (port of ``mrefsr_tpu/models/multi_ref_restoration_model.py``).

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
"""
import logging
import os
import os.path as osp
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.archs.vgg_arch import vgg_rename
from mrefsr_tpu_torch.convert import drop_buffer_keys, state_dict_from_flax
from mrefsr_tpu_torch.data.loader import default_collate
from mrefsr_tpu_torch.losses import legacy_losses
from mrefsr_tpu_torch.metrics import calculate_psnr, calculate_ssim
from mrefsr_tpu_torch.ops.cpu_bf16 import f32_products
from mrefsr_tpu_torch.parallel import data_parallel
from mrefsr_tpu_torch.utils import imwrite, tensor2img
from mrefsr_tpu_torch.utils.dist_util import get_dist_info
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .base_model import BaseModel

# the Adam groups of net_g, in the order of the learning-rate log
PARAM_GROUPS = ('g', 'offset', 'relu3_offset', 'relu2_offset')
# the values of train.mixed_precision / val.mixed_precision (unset: f32)
COMPUTE_DTYPES = {None: torch.float32, 'bfloat16': torch.bfloat16}


def compute_dtype(opt, section):
    """The compute dtype ``opt[section]['mixed_precision']`` names."""
    value = (opt.get(section) or {}).get('mixed_precision') or None
    if value not in COMPUTE_DTYPES:
        raise ValueError(f'{section}.mixed_precision is bfloat16 or unset, '
                         f'got {value!r}')
    return COMPUTE_DTYPES[value]


def cast_tensors(net, dtype):
    """``net``'s floating parameters and buffers in ``dtype``, by name: a
    differentiable cast where autograd records, so the gradients of the
    copies reach the originals (the JAX package's ``cast_tree``)."""
    return {name: t.to(dtype) if t.is_floating_point() else t
            for name, t in (*net.named_parameters(), *net.named_buffers())}


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
    """The LMR multi-reference model: eval forward and pixel-loss training.

    Weights come from ``path.pretrain_network_g``,
    ``path.pretrain_network_feature_extractor`` and
    ``path.vgg_pretrain_path`` where those files exist, from
    :meth:`load_from_flax`, and otherwise from ``manual_seed`` through a
    ``torch.Generator``. Runs on ``device`` (``cuda`` unless named).

    With ``is_train`` the extractor and the map stay frozen and run under
    ``torch.no_grad()``; ``net_g`` trains with f32 master parameters and
    one Adam of four parameter groups, its forward in f32 or, with
    ``train.mixed_precision: bfloat16``, in bf16 (``val.mixed_precision``
    likewise for ``test``; see the module docstring). With ``opt['dist']``
    (every rank a process of ``init_dist``) ``net_g`` trains in
    ``DistributedDataParallel``, each rank on its own batch, and
    validation is sharded over the ranks. The GAN phase (``network_d``,
    ``gan_type``, ``perceptual_opt``, ``style_opt``) is not ported and
    raises.
    """

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.eval_dtype = compute_dtype(opt, 'val')
        self.train_dtype = compute_dtype(opt, 'train') if self.is_train \
            else torch.float32
        if self.is_train:
            self._refuse_unported_training()
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
        # bf16 copies of frozen or eval weights, by net: (source key, copies)
        self._cast_cache = {}

        with torch.device('meta'):
            self.net_extractor = build_network(opt['network_extractor'])
            self.net_map = build_network(opt['network_map'])
            self.net_g = build_network(opt['network_g'])
        generator = torch.Generator().manual_seed(opt.get('manual_seed') or 0)
        for net in self._nets():
            net.to_empty(device=self.device)
            net.init_weights(generator)
            net.eval().requires_grad_(False)
        self._load_pretrained()
        self._to_channels_last()
        self.output = None
        if self.is_train:
            self.init_training_settings()
            if opt.get('dist'):
                self.net_g = data_parallel(self.net_g, self.device)

    def _nets(self):
        return (self.net_extractor, self.net_map,
                self.get_bare_model(self.net_g))

    def _to_channels_last(self):
        for net in self._nets():
            net.to(memory_format=torch.channels_last)

    def _load_pretrained(self):
        path = self.opt.get('path') or {}
        strict = path.get('strict_load', True)
        file = path.get('pretrain_network_feature_extractor')
        if file and os.path.isfile(file):
            self.load_network(self.net_extractor, file, strict,
                              rename=drop_buffer_keys)
        file = path.get('vgg_pretrain_path')
        if file and os.path.isfile(file):
            rename = vgg_rename(self.net_map.vgg_type)
            # torchvision's VGG goes deeper than the taps the map uses
            own = self.net_map.state_dict()

            def map_key(key):
                key = rename(key)
                key = key and f'vgg.{key}'
                return key if key in own else None

            self.load_network(self.net_map, file, True, param_key=None,
                              rename=map_key)
        file = path.get('pretrain_network_g')
        if file and os.path.isfile(file):
            self.load_network(self.get_bare_model(self.net_g), file, strict)

    def load_from_flax(self, vars_ex, vars_map, vars_g):
        """Take the JAX package's flax variables of the three nets."""
        for net, variables in zip(self._nets(), (vars_ex, vars_map, vars_g)):
            net.load_state_dict(state_dict_from_flax(variables['params']),
                                strict=True)
        self._to_channels_last()

    def _tensor(self, value):
        return torch.as_tensor(value, dtype=torch.float32, device=self.device)

    def feed_data(self, data):
        self.img_in_lq = self._tensor(data['img_in_lq'])
        self.img_ref_list = self._tensor(data['img_ref_list'])
        self.match_img_in = self._tensor(data['img_in_up'])
        self.gt = self._tensor(data['img_in']) if 'img_in' in data else None

    # ------------------------------------------------------------- training
    def _refuse_unported_training(self):
        train_opt = self.opt['train']
        for key in ('perceptual_opt', 'style_opt', 'gan_type'):
            if train_opt.get(key):
                raise NotImplementedError(
                    f'train.{key} belongs to the GAN phase, which is not '
                    'ported yet (ROADMAP A4)')
        if self.opt.get('network_d'):
            raise NotImplementedError(
                'network_d belongs to the GAN phase, which is not ported '
                'yet (ROADMAP A4)')

    def init_training_settings(self):
        """Pixel loss, the four-group Adam and its schedule (JAX package
        multi_ref_restoration_model.py:76-185). ``steps_per_dispatch`` is
        accepted: steps run one at a time, which gives the same
        trajectory."""
        train_opt = self.opt['train']
        if not train_opt['pixel_weight'] > 0:
            raise ValueError('train.pixel_weight must be > 0: the pixel '
                             'loss is the only one ported (ROADMAP A4)')
        self.cri_pix = getattr(legacy_losses, train_opt['pixel_criterion'])(
            loss_weight=train_opt['pixel_weight'], reduction='mean')
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
        self.setup_schedulers()

    def optimize_parameters(self, step):
        """One pixel-loss step of ``net_g`` on the batch of
        :meth:`feed_data`, at iteration ``step`` (1 on the first)."""
        if not self.is_train:
            raise RuntimeError('the model was built with is_train false')
        self.update_learning_rate(step)
        self.optimizer_g.zero_grad(set_to_none=True)
        l_pix = self.cri_pix(self._forward(
            self.match_img_in, self.img_ref_list, self.img_in_lq), self.gt)
        l_pix.backward()
        self.optimizer_g.step()
        self.log_dict = self.reduce_loss_dict(
            OrderedDict(l_pix=l_pix.detach()))

    def optimize_parameters_wave(self, batches, first_iter):
        """Steps ``first_iter``, ``first_iter + 1``, ... on ``batches`` in
        turn (the JAX package fuses them into one dispatch, :457-527; one
        at a time gives the same trajectory, docs/TPUDesign.md:58-66).
        The log holds the last step's losses."""
        for j, batch in enumerate(batches):
            self.feed_data(batch)
            self.optimize_parameters(first_iter + j)

    def save(self, epoch, current_iter):
        self.save_network(self.net_g, 'net_g', current_iter)
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

    def _run(self, net, dtype, cached, *args):
        """``net(*args)`` with its parameters and buffers in ``dtype``; at
        bf16 on the CPU its convolutions and products in f32, rounded once
        (:func:`~mrefsr_tpu_torch.ops.cpu_bf16.f32_products`)."""
        if dtype == torch.float32:
            return net(*args)
        with f32_products(self.device):
            if not cached:
                return functional_call(net, cast_tensors(net, dtype), args)
            sources = [*net.parameters(), *net.buffers()]
            key = (dtype, tuple((t.data_ptr(), t._version) for t in sources))
            hit = self._cast_cache.get(id(net))
            if hit is None or hit[0] != key:
                with torch.no_grad():
                    hit = self._cast_cache[id(net)] = (
                        key, cast_tensors(net, dtype))
            return functional_call(net, hit[1], args)

    def _ref_inputs(self, match_img_in, refs, dtype=torch.float32):
        """``(pre_offset, img_ref_feat)`` of ``net_g``, (B, T, ...)
        leaves, from the frozen nets in ``dtype`` (the pre-offsets are f32
        whatever it is)."""
        b, t = refs.shape[:2]
        refs = refs.to(dtype).permute(0, 1, 4, 2, 3)      # (B, T, 3, H, W)
        feats = self._run(self.net_extractor, dtype, True,
                          match_img_in.to(dtype).permute(0, 3, 1, 2), refs)
        d1 = feats['dense_features1']
        d1 = d1.unsqueeze(1).expand(-1, t, -1, -1, -1).flatten(0, 1)
        pre_offset, img_ref_feat = self._run(
            self.net_map, dtype, True,
            {'dense_features1': d1,
             'dense_features2': feats['dense_features2'].flatten(0, 1)},
            refs.flatten(0, 1))
        pre_offset = {k: v.unflatten(0, (b, t)) for k, v in pre_offset.items()}
        img_ref_feat = {k: v.unflatten(0, (b, t))
                        for k, v in img_ref_feat.items()}
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
