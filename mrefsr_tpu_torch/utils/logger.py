"""Experiment logging: the root logger, the iteration line with its ETA,
tensorboard and wandb (port of ``mrefsr_tpu/utils/logger.py``, itself the
reference's ``basicsr/utils/logger.py``). Ranks come from
``torch.distributed``; the environment banner names torch, CUDA and the
card. tensorboard and wandb are imported where they are used and, where
they are not installed, skipped with a warning, as in the JAX package:
logging is no part of the device path."""
import datetime
import logging
import os
import time

import torch

from .dist_util import get_dist_info, master_only

LOGGER_NAME = 'mrefsr_tpu_torch'
initialized_logger = {}


class AvgTimer:
    """Wall-clock time between :meth:`start` and :meth:`record`, averaged
    over a window of records (reference logger.py:10-42)."""

    def __init__(self, window=200):
        self.window = window
        self.current_time = 0
        self.total_time = 0
        self.count = 0
        self.avg_time = 0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self):
        return self.current_time

    def get_avg_time(self):
        return self.avg_time


class MessageLogger:
    """The training iteration's log line (reference logger.py:45-116):
    ``[name..][epoch, iter, lr] [eta, time (data)] l_*``, its scalars also
    to tensorboard where ``logger.use_tb_logger`` is set."""

    def __init__(self, opt, start_iter=1, tb_logger=None):
        self.exp_name = opt['name']
        self.interval = opt['logger']['print_freq']
        self.start_iter = start_iter
        self.max_iters = opt['train']['total_iter']
        self.use_tb_logger = opt['logger'].get('use_tb_logger', False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    @master_only
    def __call__(self, log_vars):
        epoch = log_vars.pop('epoch')
        current_iter = log_vars.pop('iter')
        lrs = log_vars.pop('lrs')

        message = (f'[{self.exp_name[:5]}..][epoch:{epoch:3d}, '
                   f'iter:{current_iter:8,d}, lr:(')
        for v in lrs:
            message += f'{v:.3e},'
        message += ')] '

        if 'time' in log_vars.keys():
            iter_time = log_vars.pop('time')
            data_time = log_vars.pop('data_time')
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f'[eta: {eta_str}, '
            message += f'time (data): {iter_time:.3f} ({data_time:.3f})] '

        for k, v in log_vars.items():
            message += f'{k}: {v:.4e} '
            if self.use_tb_logger and self.tb_logger is not None:
                label = f'losses/{k}' if k.startswith('l_') else k
                self.tb_logger.add_scalar(label, v, current_iter)
        self.logger.info(message)


@master_only
def init_tb_logger(log_dir):
    """A tensorboard ``SummaryWriter`` into ``log_dir``; None, with a
    warning, where tensorboard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        get_root_logger().warning(
            'tensorboard is not available; tb logging disabled.')
        return None
    return SummaryWriter(log_dir=log_dir)


@master_only
def init_wandb_logger(opt):
    """Sync to W&B (reference logger.py:126-143); skipped with a warning
    where wandb is not installed."""
    try:
        import wandb
    except ImportError:
        get_root_logger().warning('wandb is not installed; skipped.')
        return
    logger = get_root_logger()
    project = opt['logger']['wandb']['project']
    resume_id = opt['logger']['wandb'].get('resume_id')
    if resume_id:
        wandb_id = resume_id
        resume = 'allow'
        logger.warning(f'Resume wandb logger with id={wandb_id}.')
    else:
        wandb_id = wandb.util.generate_id()
        resume = 'never'
    wandb.init(id=wandb_id, resume=resume, name=opt['name'],
               config=opt, project=project, sync_tensorboard=True)
    logger.info(f'Use wandb logger with id={wandb_id}; project={project}.')


def _file_handler(log_file, log_level, format_str):
    handler = logging.FileHandler(log_file, 'w')
    handler.setFormatter(logging.Formatter(format_str))
    handler.setLevel(log_level)
    return handler


def get_root_logger(logger_name=LOGGER_NAME, log_level=logging.INFO,
                    log_file=None):
    """The package's logger (reference logger.py:146-185): a stream handler
    on every rank, and on rank 0 the level ``log_level`` and a file
    handler into ``log_file``; the other ranks log errors only. The
    package's modules log into its children, so their lines reach the
    same handlers. A later call with another ``log_file`` moves rank 0's
    file handler there (a second run in one process gets its own log)."""
    format_str = '%(asctime)s %(levelname)s: %(message)s'
    logger = logging.getLogger(logger_name)
    rank, _ = get_dist_info()
    if logger_name in initialized_logger:
        if log_file is not None and rank == 0 and not any(
                isinstance(h, logging.FileHandler)
                and h.baseFilename == os.path.abspath(log_file)
                for h in logger.handlers):
            for h in [h for h in logger.handlers
                      if isinstance(h, logging.FileHandler)]:
                logger.removeHandler(h)
                h.close()
            logger.addHandler(_file_handler(log_file, log_level, format_str))
        return logger

    stream_handler = logging.StreamHandler()
    stream_handler.setFormatter(logging.Formatter(format_str))
    logger.addHandler(stream_handler)
    logger.propagate = False
    if rank != 0:
        logger.setLevel('ERROR')
    else:
        logger.setLevel(log_level)
        if log_file is not None:
            logger.addHandler(_file_handler(log_file, log_level, format_str))
    initialized_logger[logger_name] = True
    return logger


def get_env_info():
    """The environment banner: the port's version, torch, CUDA and the
    cards (reference logger.py:188-213)."""
    from mrefsr_tpu_torch.version import __version__
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        devices = f'{count} x {torch.cuda.get_device_name(0)}'
    else:
        devices = 'cpu (no CUDA device)'
    rank, world_size = get_dist_info()
    return ('\nFramework: mrefsr_tpu_torch'
            f'\n\tVersion: {__version__}'
            f'\n\tPyTorch: {torch.__version__}'
            f'\n\tCUDA: {torch.version.cuda}'
            f'\n\tDevices: {devices}'
            f'\n\tProcesses: {world_size} (this is rank {rank})')
