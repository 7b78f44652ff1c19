"""The training CLI (port of ``mrefsr_tpu/train.py``, the reference's
``basicsr/train.py:17-215``)::

    python -m mrefsr_tpu_torch.train -opt options/train/<yml> [--device cpu]
    torchrun --nproc_per_node N -m mrefsr_tpu_torch.train -opt <yml> \\
        --launcher pytorch

parses the options, resumes where asked, makes the experiment's
directories and loggers, builds the loaders and the model, and runs the
epoch and iteration loop through the model's ``feed_data`` ->
``optimize_parameters`` -> ``get_current_log``, saving and validating at
the YAML's frequencies.

Where the JAX CLI's choices were the TPU's, this one decides otherwise:

* **A process a card.** The JAX CLI runs one process over all local chips
  and multiplies the loader's batch by ``num_gpu`` (its train.py:46-67).
  Here each rank is one process with one card, as the reference's DDP: the
  loader's batch is ``batch_size_per_gpu``, the global batch that times the
  world size (both logged in the training statistics). ``num_gpu`` is read
  and multiplies nothing.
* **One batch an iteration.** ``train.steps_per_dispatch`` fuses steps into
  one dispatch in the JAX package; the port's model steps one iteration at
  a time, which gives the same trajectory. So the loop fetches one batch
  an iteration and logs, saves and validates at each multiple of
  ``print_freq``, ``save_checkpoint_freq`` and ``val_freq``, where the JAX
  CLI fires where a wave of steps crosses one (with waves of 16 and
  ``print_freq`` 100 it logs at 112; this loop logs at 100). A wave that
  crosses ``net_g_pretrain_steps`` needs no special case either: the
  iteration after the boundary is the first GAN step.
* **Prefetch.** ``prefetch_mode: device`` copies the batches on a thread of
  their own and turns uint8 into float32 on the card
  (``data/prefetch_dataloader.py``); ``cuda`` copies on a side stream of
  this thread; ``cpu`` or unset hands host batches to ``feed_data``.
* **Kernels before collectives.** ``parse_options`` builds every CUDA
  kernel before ``init_dist``, so that no first-launch ``nvcc`` run falls
  inside the collectives' 60 s timeout.
* **Preemption.** The first SIGTERM or SIGINT sets a flag; the loop ends
  the iteration, saves ``<iter>.state`` and ``net_g_<iter>.pth`` (and
  ``net_d_<iter>.pth`` in a GAN run) and returns, and the process exits 0. A second signal kills. Every rank of a
  run must get the signal (launchers forward it). ``--auto_resume`` takes
  the newest ``.state`` under ``path.training_states``, loaded onto the
  rank's device, and the loop goes on from its iteration and epoch. The
  handlers are put back as they were when the pipeline returns.
* **Validation** goes through the model's ``validation``, sharded over the
  ranks in a run of several. A model that validates without data
  (``validates_without_data``: StyleGAN2's samples of fixed codes) does so
  at ``val.val_freq`` when the options name no validation set, where the
  JAX CLI, finding no loader, never validates it.

* **Profiler window.** ``logger.profile_start_iter`` (with
  ``profile_num_steps`` and ``profile_dir``) profiles that many iterations
  from the first at or past it with ``torch.profiler`` and writes a Chrome
  trace under ``<experiments_root>/tb_logger/`` (``utils/profiler.py``),
  as the JAX CLI's ``jax.profiler`` window.

The JAX CLI's XLA compilation cache has no counterpart here.
"""
import datetime
import logging
import math
import os
import signal
import time
from os import path as osp

import torch

from mrefsr_tpu_torch.data import (BackgroundDevicePrefetcher, CPUPrefetcher,
                                   CUDAPrefetcher, EnlargedSampler,
                                   build_dataloader, build_dataset)
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.utils import resolve_device
from mrefsr_tpu_torch.utils.logger import (AvgTimer, MessageLogger,
                                           get_env_info, get_root_logger,
                                           init_tb_logger, init_wandb_logger)
from mrefsr_tpu_torch.utils.misc import (check_resume, get_time_str,
                                         make_exp_dirs, mkdir_and_rename,
                                         scandir)
from mrefsr_tpu_torch.utils.options import (copy_opt_file, dict2str,
                                            parse_options)
from mrefsr_tpu_torch.utils.profiler import StepProfiler

PREFETCH_MODES = (None, 'cpu', 'cuda', 'device')


def init_tb_loggers(opt):
    """wandb where ``logger.wandb.project`` is set, and tensorboard where
    ``logger.use_tb_logger`` is, but not in debug runs (reference
    train.py:17-26). Returns the tensorboard writer or None."""
    if (opt['logger'].get('wandb') is not None
            and opt['logger']['wandb'].get('project') is not None
            and 'debug' not in opt['name']):
        if opt['logger'].get('use_tb_logger') is not True:
            raise ValueError('should turn on tensorboard when using wandb')
        init_wandb_logger(opt)
    if opt['logger'].get('use_tb_logger') and 'debug' not in opt['name']:
        return init_tb_logger(
            log_dir=osp.join(opt['root_path'], 'tb_logger', opt['name']))
    return None


def create_train_val_dataloader(opt, logger):
    """The training loader and sampler, the validation loaders and the
    run's length (reference train.py:29-65). The training set draws with
    the rank's seed."""
    train_loader, train_sampler, val_loaders = None, None, []
    for phase, dataset_opt in opt['datasets'].items():
        if phase == 'train':
            ratio = dataset_opt.get('dataset_enlarge_ratio', 1)
            train_set = build_dataset(dataset_opt,
                                      seed=opt['manual_seed'] + opt['rank'])
            train_sampler = EnlargedSampler(train_set, opt['world_size'],
                                            opt['rank'], ratio)
            train_loader = build_dataloader(train_set, dataset_opt,
                                            sampler=train_sampler,
                                            seed=opt['manual_seed'])
            batch = dataset_opt['batch_size_per_gpu']
            num_iter_per_epoch = math.ceil(len(train_sampler) / batch)
            total_iters = int(opt['train']['total_iter'])
            total_epochs = math.ceil(total_iters / num_iter_per_epoch)
            logger.info(
                'Training statistics:'
                f'\n\tNumber of train images: {len(train_set)}'
                f'\n\tDataset enlarge ratio: {ratio}'
                f'\n\tBatch size per process: {batch}'
                f'\n\tWorld size (processes): {opt["world_size"]}'
                f'\n\tGlobal batch size: {batch * opt["world_size"]}'
                f'\n\tRequire iter number per epoch: {num_iter_per_epoch}'
                f'\n\tTotal epochs: {total_epochs}; iters: {total_iters}.')
        elif phase.split('_')[0] in ('val', 'test'):
            val_set = build_dataset(dataset_opt)
            val_loaders.append(build_dataloader(val_set, dataset_opt))
            logger.info(f'Number of val images/folders in '
                        f'{dataset_opt["name"]}: {len(val_set)}')
        else:
            raise ValueError(f'Dataset phase {phase} is not recognized.')
    if train_loader is None:
        raise ValueError('the options have no datasets.train')
    return train_loader, train_sampler, val_loaders, total_epochs, \
        total_iters


def load_resume_state(opt, device):
    """The ``.state`` to resume from, loaded onto ``device``: with
    ``--auto_resume`` the newest under ``path.training_states`` (the
    derived path, not the reference's cwd-relative one), else
    ``path.resume_state``; None if neither. Points the pretrained paths at
    its iteration's checkpoints (``check_resume``)."""
    resume_state_path = None
    if opt['auto_resume']:
        state_path = opt['path']['training_states']
        if osp.isdir(state_path):
            states = list(scandir(state_path, suffix='.state'))
            if states:
                newest = max(float(v.split('.state')[0]) for v in states)
                resume_state_path = osp.join(state_path,
                                             f'{newest:.0f}.state')
                opt['path']['resume_state'] = resume_state_path
    elif opt['path'].get('resume_state'):
        resume_state_path = opt['path']['resume_state']
    if resume_state_path is None:
        return None
    resume_state = torch.load(resume_state_path, map_location=device,
                              weights_only=True)
    check_resume(opt, resume_state['iter'])
    return resume_state


class _Preemption:
    """SIGTERM and SIGINT set :attr:`stop`; a second one restores the
    default disposition and raises it again, so that a stuck run can still
    be killed. Off the main thread (a library caller's thread) the
    dispositions are left alone. :meth:`restore` puts back the handlers
    that were there before."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.stop = False
        self._before = {}
        try:
            for sig in self.SIGNALS:
                self._before[sig] = signal.signal(sig, self._handler)
        except ValueError:
            pass

    def _handler(self, signum, frame):
        if self.stop:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.stop = True

    def restore(self):
        for sig, handler in self._before.items():
            signal.signal(sig, handler)
        self._before = {}


def _prefetcher(opt, model, train_loader, logger):
    mode = opt['datasets']['train'].get('prefetch_mode')
    if mode not in PREFETCH_MODES:
        raise ValueError(f'prefetch_mode is cpu, cuda, device or unset, '
                         f'got {mode!r}')
    if mode in (None, 'cpu'):
        return CPUPrefetcher(train_loader)
    logger.info(f'Use {mode} prefetch dataloader.')
    if mode == 'cuda':
        return CUDAPrefetcher(train_loader, model.device,
                              device_keys=model.device_input_keys)
    return BackgroundDevicePrefetcher(
        train_loader, model.device, opt,
        device_keys=model.device_input_keys,
        depth=opt['datasets']['train'].get('prefetch_depth'))


def train_pipeline(root_path, args=None):
    """Train as the options of the command line ``args`` (``sys.argv[1:]``
    by default) say; returns the model."""
    opt, cli_args = parse_options(root_path, is_train=True, args=args)
    opt['root_path'] = root_path
    device = resolve_device(cli_args.device)

    resume_state = load_resume_state(opt, device)
    if resume_state is None:
        make_exp_dirs(opt)
        if (opt['logger'].get('use_tb_logger')
                and 'debug' not in opt['name'] and opt['rank'] == 0):
            mkdir_and_rename(osp.join(root_path, 'tb_logger', opt['name']))
    copy_opt_file(cli_args.opt, opt['path']['experiments_root'])

    log_file = osp.join(opt['path']['log'],
                        f"train_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = init_tb_loggers(opt)

    train_loader, train_sampler, val_loaders, total_epochs, total_iters = \
        create_train_val_dataloader(opt, logger)

    model = build_model(opt, device=device)
    if opt.get('val') and not val_loaders \
            and getattr(model, 'validates_without_data', False):
        val_loaders = [None]
    if resume_state:
        model.resume_training(resume_state)
        logger.info(f"Resuming training from epoch: {resume_state['epoch']}, "
                    f"iter: {resume_state['iter']}.")
        start_epoch = resume_state['epoch']
        current_iter = resume_state['iter']
    else:
        start_epoch = 0
        current_iter = 0

    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    prefetcher = _prefetcher(opt, model, train_loader, logger)
    if int(opt['train'].get('steps_per_dispatch') or 1) > 1:
        logger.info('steps_per_dispatch: the steps run one at a time, with '
                    'the same trajectory.')
    print_freq = int(opt['logger']['print_freq'])
    save_freq = int(opt['logger']['save_checkpoint_freq'])
    val_freq = int(opt['val']['val_freq']) if opt.get('val') else None
    save_img = (opt.get('val') or {}).get('save_img', False)
    warmup_iter = opt['train'].get('warmup_iter', -1)

    logger.info(f'Start training from epoch: {start_epoch}, '
                f'iter: {current_iter}')
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    profiler = StepProfiler(opt)
    start_time = time.time()
    start_iter = current_iter
    preempt = _Preemption()
    try:
        epoch = start_epoch
        while current_iter < total_iters:
            train_sampler.set_epoch(epoch)
            prefetcher.reset()
            train_data = prefetcher.next()
            while train_data is not None and current_iter < total_iters:
                data_timer.record()
                current_iter += 1
                model.update_learning_rate(current_iter,
                                           warmup_iter=warmup_iter)
                profiler.maybe_start(current_iter)
                model.feed_data(train_data)
                model.optimize_parameters(current_iter)
                profiler.maybe_stop(current_iter)
                iter_timer.record()
                if current_iter == start_iter + 1:
                    msg_logger.reset_start_time()
                if current_iter % print_freq == 0:
                    log_vars = {'epoch': epoch, 'iter': current_iter,
                                'lrs': model.get_current_learning_rate(),
                                'time': iter_timer.get_avg_time(),
                                'data_time': data_timer.get_avg_time()}
                    log_vars.update(model.get_current_log())
                    msg_logger(log_vars)
                if current_iter % save_freq == 0:
                    logger.info('Saving models and training states.')
                    model.save(epoch, current_iter)
                if val_freq and current_iter % val_freq == 0:
                    for val_loader in val_loaders:
                        model.validation(val_loader, current_iter, tb_logger,
                                         save_img)
                if preempt.stop:
                    break
                data_timer.start()
                iter_timer.start()
                train_data = prefetcher.next()
            if preempt.stop:
                logger.info(f'Preemption signal received: saving state at '
                            f'iter {current_iter} and stopping cleanly.')
                model.save(epoch, current_iter)
                return model
            epoch += 1

        profiler.close(current_iter)    # before the last save and validation
        consumed = str(datetime.timedelta(seconds=int(time.time()
                                                      - start_time)))
        logger.info(f'End of training. Time consumed: {consumed}')
        logger.info('Save the latest model.')
        model.save(epoch=-1, current_iter=-1)
        if opt.get('val') is not None:
            for val_loader in val_loaders:
                model.validation(val_loader, current_iter, tb_logger,
                                 save_img)
        return model
    finally:
        # writes a window still open when the loop ends, however it ends
        profiler.close(current_iter)
        preempt.restore()
        prefetcher.close()
        if tb_logger:
            tb_logger.close()


if __name__ == '__main__':
    train_pipeline(osp.abspath(osp.join(__file__, osp.pardir, osp.pardir)))
