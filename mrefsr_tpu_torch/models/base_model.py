"""BaseModel: what every training strategy of the port shares (port of
``mrefsr_tpu/models/base_model.py``): the device, the schedulers and the
learning-rate log, and checkpoints in the reference's formats.

* ``<label>_<iter>.pth`` holds ``{'params': state_dict}`` (or one state
  dict per key, e.g. ``params`` and ``params_ema``) with the reference's
  torch key names, so one file loads into the reference, the JAX package
  (``mrefsr_tpu.convert``) and this package.
* ``<iter>.state`` holds ``{'epoch', 'iter', 'optimizers', 'schedulers'}``
  (reference base_model.py:308-341), one entry per optimizer, written
  with ``torch.save``.

In a run of several ranks (``opt['dist']``, see ``utils/dist_util.py``)
only rank 0 writes either file, from the bare net (no ``module.``
prefix), and every rank resumes from them onto its own device.
"""
import logging
import os
from collections import OrderedDict

import numpy as np
import torch
from torch.func import functional_call
from torch.nn.parallel import DistributedDataParallel

from mrefsr_tpu_torch.convert import load_torch_state_dict, rename_keys
from mrefsr_tpu_torch.data.prefetch_dataloader import uint8_to_float32
from mrefsr_tpu_torch.ops.cpu_bf16 import f32_products
from mrefsr_tpu_torch.parallel import all_reduce_mean
from mrefsr_tpu_torch.utils import resolve_device
from mrefsr_tpu_torch.utils.dist_util import master_only

from .lr_scheduler import ScheduleLR, build_schedule

logger = logging.getLogger(__name__)

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


def constant_buffers(net):
    """The names of ``net``'s buffers that no flax variable holds: every
    buffer but a norm's running mean and variance (SpyNet's ImageNet mean
    and std, ``num_batches_tracked``)."""
    stats = {f'{name}.{stat}' if name else stat
             for name, module in net.named_modules()
             if isinstance(module, torch.nn.modules.batchnorm._NormBase)
             for stat in ('running_mean', 'running_var')}
    return {name for name, _ in net.named_buffers()} - stats


class BaseModel:

    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        self.is_train = bool(opt.get('is_train'))
        self.optimizers = []
        self.schedulers = []
        self.log_dict = {}
        # bf16 copies of frozen or eval weights, by net: (source key, copies)
        self._cast_cache = {}

    # ----------------------------------------------------------- schedulers
    def setup_schedulers(self):
        """One :class:`ScheduleLR` per optimizer, from ``train.scheduler``
        and ``train.warmup_iter`` (reference base_model.py:106-124). Call
        after the optimizers exist."""
        train_opt = self.opt['train']
        base_lr = (train_opt.get('optim_g') or {}).get('lr') \
            or train_opt.get('lr_g') or 1.0
        self.schedule_fn = build_schedule(train_opt.get('scheduler'),
                                          train_opt.get('warmup_iter', -1),
                                          base_lr=base_lr)
        self.schedulers = [ScheduleLR(optimizer, self.schedule_fn)
                           for optimizer in self.optimizers]

    def update_learning_rate(self, current_iter, warmup_iter=-1):
        """Set the rates iteration ``current_iter`` trains with. The
        warm-up is part of the schedule (``train.warmup_iter``);
        ``warmup_iter`` is accepted for the reference's call signature."""
        for scheduler in self.schedulers:
            scheduler.step(current_iter)

    def get_current_learning_rate(self):
        """The first optimizer's rate per parameter group."""
        return self.schedulers[0].get_last_lr() if self.schedulers else [0.0]

    @staticmethod
    def get_bare_model(net):
        """``net`` without its ``DistributedDataParallel`` wrapper."""
        if isinstance(net, DistributedDataParallel):
            return net.module
        return net

    def reduce_loss_dict(self, loss_dict):
        """The losses averaged over the ranks, as 0-d tensors (reference
        base_model.py:358-383): with equal batches on every rank that is
        the global batch's mean, which the JAX step logs. One all-reduce
        in a run of several ranks; the dict itself otherwise."""
        return OrderedDict(zip(loss_dict,
                               all_reduce_mean(list(loss_dict.values()))))

    def validation(self, dataloader, current_iter, tb_logger,
                   save_img=False):
        """Validate on ``dataloader``: sharded over the ranks when
        ``opt['dist']``, on this process otherwise (reference
        base_model.py:36-48)."""
        if self.opt.get('dist'):
            self.dist_validation(dataloader, current_iter, tb_logger,
                                 save_img)
        else:
            self.nondist_validation(dataloader, current_iter, tb_logger,
                                    save_img)

    # ------------------------------------------------------- best metrics
    def _initialize_best_metric_results(self, dataset_name):
        """The best value and iteration of each ``val.metrics`` entry on
        ``dataset_name``, -inf / inf to start (reference
        base_model.py:50-73); kept where it is already there."""
        if not hasattr(self, 'best_metric_results'):
            self.best_metric_results = {}
        if dataset_name in self.best_metric_results:
            return
        record = {}
        for metric, content in self.opt['val']['metrics'].items():
            better = content.get('better', 'higher')
            record[metric] = {'better': better, 'iter': -1,
                              'val': float('-inf') if better == 'higher'
                              else float('inf')}
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name, metric, val,
                                   current_iter):
        rec = self.best_metric_results[dataset_name][metric]
        if (val >= rec['val']) if rec['better'] == 'higher' \
                else (val <= rec['val']):
            rec['val'] = val
            rec['iter'] = current_iter

    def get_current_log(self):
        """The last step's losses as python floats. Converting waits for
        the device, so the step itself keeps them as tensors."""
        return {k: float(v) for k, v in self.log_dict.items()}

    # ------------------------------------------------------------------ EMA
    @staticmethod
    @torch.no_grad()
    def ema_update(net_ema, net, decay):
        """``ema = decay * ema + (1 - decay) * net`` over the parameters,
        in place (reference ``model_ema``, base_model.py:75-82)."""
        for ema, param in zip(net_ema.parameters(), net.parameters()):
            ema.mul_(decay).add_(param, alpha=1 - decay)

    # ---------------------------------------------------------- checkpoints
    @master_only
    def save_network(self, net, net_label, current_iter, param_key='params'):
        """Write ``net``'s state dict as a reference-format ``.pth``
        (reference base_model.py:198-243) into ``path.models``; iteration
        -1 is named ``latest``. ``net`` and ``param_key`` may be lists of
        equal length: one file then holds one state dict per key (a
        generator and its EMA under ``params`` and ``params_ema``).
        Returns the file's path; rank 0 writes, the other ranks return
        None."""
        nets = net if isinstance(net, list) else [net]
        keys = param_key if isinstance(param_key, list) else [param_key]
        if len(nets) != len(keys):
            raise ValueError(f'{len(nets)} nets for the keys {keys}')
        name = 'latest' if current_iter == -1 else current_iter
        path = os.path.join(self.opt['path']['models'],
                            f'{net_label}_{name}.pth')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({key: {k: v.detach().cpu().contiguous()
                          for k, v in
                          self.get_bare_model(one).state_dict().items()}
                    for one, key in zip(nets, keys)}, path)
        return path

    def load_network(self, net, load_path, strict=True, param_key='params',
                     rename=None):
        """Load a reference-format ``.pth`` into ``net`` (reference
        base_model.py:280-306, the ``params_ema`` -> ``params`` fall-back
        included) as the JAX package's ``_merge_loaded`` overlays a file
        on the initialised variables (its base_model.py:324): a key the
        file lacks, a key the net lacks and a tensor of another size are
        each logged and keep the net's value, and with ``strict`` raise. A
        constant buffer the file lacks (:func:`constant_buffers`: a JAX
        checkpoint holds none) keeps its value without a word. ``rename(key)
        -> key or None`` maps or drops the file's keys."""
        state = load_torch_state_dict(load_path, param_key=param_key)
        if rename is not None:
            state = rename_keys(state, rename)
        net = self.get_bare_model(net)
        own = net.state_dict()
        constants = constant_buffers(net)
        problems, keep = [], {}
        for key, value in state.items():
            if key not in own:
                problems.append(f'unexpected ckpt key: {key}')
            elif tuple(value.shape) != tuple(own[key].shape):
                problems.append(f'Size different for {key}: ckpt '
                                f'{tuple(value.shape)} vs model '
                                f'{tuple(own[key].shape)}; ignored.')
            else:
                keep[key] = value
        problems += [f'missing key in checkpoint: {key}' for key in own
                     if key not in state and key not in constants]
        if strict and problems:
            raise ValueError(
                'Checkpoint does not match the network (strict load): '
                + '; '.join(problems[:20])
                + (f'; ... {len(problems) - 20} more'
                   if len(problems) > 20 else ''))
        for msg in problems:
            logger.warning(msg)
        logger.info(f'Loading {type(net).__name__} from {load_path} '
                    f'[param_key: {param_key}].')
        net.load_state_dict(keep, strict=False)

    def _run(self, net, dtype, cached, *args):
        """``net(*args)`` with its parameters and buffers in ``dtype``; at
        bf16 they are cast copies: made anew, differentiable, unless
        ``cached`` (eval, frozen nets), then once per weights; on the CPU
        the convolutions and products run in f32 and round once
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

    def _tensor(self, value):
        """A batch array as a float32 tensor on the model's device. uint8
        (a dataset's ``output_dtype: uint8``) becomes ``astype(float32) /
        255``, the JAX package's host formula (its ``_as_f32``); float
        arrays are cast, and the f32 tensors a device prefetcher hands over
        pass through as they are."""
        if getattr(value, 'dtype', None) in (np.uint8, torch.uint8):
            value = uint8_to_float32(value)
        return torch.as_tensor(value, dtype=torch.float32, device=self.device)

    def named_file(self, key):
        """``path.<key>``, or None where it is unset. A named file that is
        not on disk raises (as the JAX package's loader does), rather than
        leaving seeded weights to train: set the key to ``~`` to start from
        them."""
        file = (self.opt.get('path') or {}).get(key)
        if file and not os.path.isfile(file):
            raise FileNotFoundError(
                f'path.{key} names {file}, which does not exist (set it '
                'to ~ to start from the seeded weights)')
        return file

    @torch.no_grad()
    def load_vgg_weights(self, vgg):
        """Weights for the VGG tower of a perceptual, style or texture loss
        (a :class:`~mrefsr_tpu_torch.archs.vgg_arch.VGGFeatureExtractor`,
        made on ``meta`` or anywhere), on this model's device (JAX package
        base_model.py:372-390): from ``path.vgg_pretrain_path``, a
        torchvision-layout ``.pth``, where it names one; else seeded
        (N(0, 1/fan_in), from seed 0, as the JAX package's fall-back
        initialises with key 0)."""
        from mrefsr_tpu_torch.archs.vgg_arch import vgg_rename
        vgg.to_empty(device=self.device)
        file = self.named_file('vgg_pretrain_path')
        if not file:
            vgg.init_weights(torch.Generator().manual_seed(0))
        else:
            own = vgg.state_dict()
            rename = vgg_rename(vgg.vgg_type)
            state = rename_keys(load_torch_state_dict(file, param_key=None),
                                lambda key: key if rename(key) in own
                                else None)
            vgg.load_state_dict(rename_keys(state, rename), strict=True)
        vgg.eval().requires_grad_(False)
        return vgg

    @master_only
    def save_training_state(self, epoch, current_iter):
        """Write the trainer's state into ``path.training_states`` as
        ``<iter>.state``. Returns the file's path (None for iteration
        -1, which the reference does not save either, and on every rank
        but 0)."""
        if current_iter == -1:
            return None
        state = {'epoch': epoch, 'iter': current_iter,
                 'optimizers': [o.state_dict() for o in self.optimizers],
                 'schedulers': [s.state_dict() for s in self.schedulers]}
        path = os.path.join(self.opt['path']['training_states'],
                            f'{current_iter}.state')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(state, path)
        return path

    def load_training_state(self, path):
        """A ``.state`` file, its tensors on this rank's device."""
        return torch.load(path, map_location=self.device, weights_only=True)

    def resume_training(self, resume_state):
        """Restore optimizers and schedulers from a loaded ``.state``
        (reference base_model.py:343-356); every rank calls it."""
        optimizers = resume_state['optimizers']
        schedulers = resume_state['schedulers']
        if len(optimizers) != len(self.optimizers) \
                or len(schedulers) != len(self.schedulers):
            raise ValueError(
                f'the state holds {len(optimizers)} optimizers and '
                f'{len(schedulers)} schedulers, the model '
                f'{len(self.optimizers)} and {len(self.schedulers)}')
        for optimizer, state in zip(self.optimizers, optimizers):
            optimizer.load_state_dict(state)
        for scheduler, state in zip(self.schedulers, schedulers):
            scheduler.load_state_dict(state)
