"""Host-side helpers of the CLIs: seeding, experiment directories, file
scans and resume paths (port of ``mrefsr_tpu/utils/misc.py``, itself the
reference's ``basicsr/utils/misc.py:13-143``). ``set_random_seed`` seeds
torch too, as the reference's does; the JAX package seeds python and numpy
only and derives its device keys from the seed."""
import os
import os.path as osp
import random
import time

import numpy as np
import torch

from .dist_util import master_only


def set_random_seed(seed):
    """Seed python's, numpy's and torch's global generators (torch's
    covers every CUDA device). Returns ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def get_time_str():
    return time.strftime('%Y%m%d_%H%M%S', time.localtime())


def mkdir_and_rename(path):
    """Make ``path``; an existing one is first renamed with a time stamp,
    so an old experiment is archived, never overwritten (reference
    misc.py:26-37)."""
    if osp.exists(path):
        new_name = path + '_archived_' + get_time_str()
        print(f'Path already exists. Rename it to {new_name}', flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


@master_only
def make_exp_dirs(opt):
    """The experiment's directories (reference misc.py:40-51): the root
    archived and made anew, then every other directory of ``opt['path']``
    that is not a file to load."""
    path_opt = opt['path'].copy()
    if opt['is_train']:
        mkdir_and_rename(path_opt.pop('experiments_root'))
    else:
        mkdir_and_rename(path_opt.pop('results_root'))
    for key, path in path_opt.items():
        if ('strict_load' in key) or ('pretrain_network' in key) or (
                'resume' in key) or ('param_key' in key):
            continue
        if isinstance(path, str):
            os.makedirs(path, exist_ok=True)


def scandir(dir_path, suffix=None, recursive=False, full_path=False):
    """The files under ``dir_path`` (hidden ones left out), relative to it
    unless ``full_path``, those ending in ``suffix`` where given
    (reference misc.py:54-93)."""
    if (suffix is not None) and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')
    root = dir_path

    def _scandir(dir_path, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith('.') and entry.is_file():
                return_path = entry.path if full_path \
                    else osp.relpath(entry.path, root)
                if suffix is None or return_path.endswith(suffix):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix=suffix,
                                    recursive=recursive)

    return _scandir(dir_path, suffix=suffix, recursive=recursive)


def check_resume(opt, resume_iter):
    """When ``path.resume_state`` is set, point ``pretrain_network_<net>``
    of every ``network_<net>`` at ``models/net_<net>_<iter>.pth``, except
    the nets ``ignore_resume_networks`` lists, and ``param_key_*``
    ``params_ema`` at ``params`` (reference misc.py:96-126)."""
    if not opt['path'].get('resume_state'):
        return
    networks = [key for key in opt.keys() if key.startswith('network_')]
    if any(opt['path'].get(f'pretrain_{network}') is not None
           for network in networks):
        print('pretrain_network paths will be ignored during resuming.',
              flush=True)
    for network in networks:
        name = f'pretrain_{network}'
        basename = network.replace('network_', '')
        if opt['path'].get('ignore_resume_networks') is None or (
                network not in opt['path']['ignore_resume_networks']):
            opt['path'][name] = osp.join(opt['path']['models'],
                                         f'net_{basename}_{resume_iter}.pth')
            print(f"Set {name} to {opt['path'][name]}", flush=True)
    for param_key in [key for key in opt['path']
                      if key.startswith('param_key')]:
        if opt['path'][param_key] == 'params_ema':
            opt['path'][param_key] = 'params'
            print(f'Set {param_key} to params', flush=True)


def sizeof_fmt(size, suffix='B'):
    """``size`` bytes in a human readable unit (reference misc.py:129-143)."""
    for unit in ['', 'K', 'M', 'G', 'T', 'P', 'E', 'Z']:
        if abs(size) < 1024.0:
            return f'{size:3.1f} {unit}{suffix}'
        size /= 1024.0
    return f'{size:3.1f} Y{suffix}'
