"""YAML experiment options: parse, override, derive paths (port of
``mrefsr_tpu/utils/options.py``, itself the reference's
``basicsr/utils/options.py:82-195``).

One YAML describes an experiment; the CLI flags are the JAX package's
(``-opt``, ``--launcher``, ``--auto_resume``, ``--debug``, ``--force_yml``,
``--local_rank``) plus ``--device``. For the same YAML and flags
:func:`parse_options` returns the JAX package's dict, key for key, but for
these differences:

* ``--launcher`` is ``none`` or ``pytorch`` (torchrun's env contract,
  ``utils/dist_util.py``); the JAX package's ``slurm`` and ``jax`` are
  refused by the parser. ``dist_params`` go to the port's ``init_dist``
  (``backend``, ``port``, ``init_method``).
* ``--device`` names the device the CLIs run on: ``cuda`` (the rank's card)
  unless ``--device cpu``; with no card and no ``--device cpu`` parsing
  raises. On a CUDA device every kernel is built here, before
  ``init_dist``'s first collective, so that a first launch's ``nvcc`` run
  cannot fall inside the collectives' 60 s timeout.
* ``num_gpu: auto`` becomes ``torch.cuda.device_count()``. ``num_gpu``
  multiplies no batch in the port (``mrefsr_tpu_torch/train.py``).
* The JAX package's persistent XLA compilation cache
  (``compilation_cache``, ``compile_cache``, ``MREFSR_XLA_CACHE_DIR``) has
  no counterpart: the keys are accepted and ignored.
* ``set_random_seed`` seeds torch as well as python and numpy.
* ``--force_yml`` is applied as soon as the YAML is read, so it can set
  ``dist_params`` and ``manual_seed`` too; the JAX package applies it after
  joining the group and seeding, which then ignore it.

``--force_yml`` values are parsed with ``ast.literal_eval`` (``~``, ``none``
and ``null`` are None), never ``eval``.
"""
import argparse
import ast
import os.path as osp
import random
import sys

import torch

from mrefsr_tpu_torch.utils import resolve_device

from .dist_util import get_dist_info, init_dist, master_only
from .misc import set_random_seed


def _parse_scalar(value):
    """A ``--force_yml`` value: None, a bool, a Python literal or else the
    string itself."""
    if value in ('~', 'none', 'None', 'null'):
        return None
    if value in ('true', 'True'):
        return True
    if value in ('false', 'False'):
        return False
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def ordered_yaml():
    """``(Loader, Dumper)``: PyYAML's safe ones, the C ones where they are
    built; dicts keep the file's order (reference options.py:12-34)."""
    import yaml
    return (getattr(yaml, 'CSafeLoader', yaml.SafeLoader),
            getattr(yaml, 'CSafeDumper', yaml.SafeDumper))


def yaml_load(f):
    """Load YAML from a file path or a string (reference options.py:37-49).
    A string that names a ``.yml`` / ``.yaml`` file that does not exist
    raises rather than parsing as a scalar."""
    import yaml
    if osp.isfile(f):
        with open(f, 'r') as fh:
            return yaml.load(fh, Loader=ordered_yaml()[0])
    if f.endswith(('.yml', '.yaml')) and '\n' not in f:
        raise FileNotFoundError(f'Option file not found: {f}')
    return yaml.load(f, Loader=ordered_yaml()[0])


def dict2str(opt, indent_level=1):
    """An options dict as indented text (reference options.py:52-70)."""
    msg = '\n'
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += ' ' * (indent_level * 2) + k + ':['
            msg += dict2str(v, indent_level + 1)
            msg += ' ' * (indent_level * 2) + ']\n'
        else:
            msg += ' ' * (indent_level * 2) + k + ': ' + str(v) + '\n'
    return msg


def _set_by_path(d, keys, value):
    for key in keys[:-1]:
        d = d.setdefault(key, {})
    d[keys[-1]] = value


def parse_options(root_path, is_train=True, args=None):
    """The experiment's options from the command line ``args``
    (``sys.argv[1:]`` by default) and its YAML: ``--force_yml`` applied,
    the process group joined, the rank's seed set, each dataset's phase and
    scale, the derived experiment paths, and debug mode's frequencies.
    Returns ``(opt, args)``."""
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--launcher', choices=['none', 'pytorch'],
                        default='none', help='job launcher')
    parser.add_argument('--auto_resume', action='store_true')
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--local_rank', type=int, default=0)
    parser.add_argument(
        '--force_yml', nargs='+', default=None,
        help='Force to update yml files. Examples: train:ema_decay=0.999')
    parser.add_argument('--device', default=None,
                        help='cuda (the default: the rank\'s card) or cpu')
    args = parser.parse_args(args=args if args is not None
                             else sys.argv[1:])

    opt = yaml_load(args.opt)
    if args.force_yml is not None:
        for entry in args.force_yml:
            entry = entry.replace(' ', '')
            keys, value = entry.split('=', 1)
            _set_by_path(opt, keys.split(':'), _parse_scalar(value))

    if resolve_device(args.device).type == 'cuda':
        from mrefsr_tpu_torch.ops import _build
        _build.build()

    if args.launcher == 'none':
        opt['dist'] = False
    else:
        opt['dist'] = True
        init_dist(args.launcher, **opt.get('dist_params', {}) or {})
    opt['rank'], opt['world_size'] = get_dist_info()

    seed = opt.get('manual_seed')
    if seed is None:
        seed = random.randint(1, 10000)
        opt['manual_seed'] = seed
    set_random_seed(seed + opt['rank'])

    opt['auto_resume'] = args.auto_resume
    opt['is_train'] = is_train

    if args.debug and not opt['name'].startswith('debug'):
        opt['name'] = 'debug_' + opt['name']

    if opt.get('num_gpu', None) == 'auto':
        opt['num_gpu'] = torch.cuda.device_count()

    for phase, dataset in (opt.get('datasets') or {}).items():
        # several datasets of a phase: val_1, val_2; test_1, test_2
        phase = phase.split('_')[0]
        dataset['phase'] = phase
        if 'scale' in opt:
            dataset['scale'] = opt['scale']
        if dataset.get('dataroot_gt') is not None:
            dataset['dataroot_gt'] = osp.expanduser(dataset['dataroot_gt'])
        if dataset.get('dataroot_lq') is not None:
            dataset['dataroot_lq'] = osp.expanduser(dataset['dataroot_lq'])

    opt.setdefault('path', {})
    for key, val in opt['path'].items():
        if (val is not None) and ('resume_state' in key
                                  or 'pretrain_network' in key):
            opt['path'][key] = osp.expanduser(val)

    if is_train:
        experiments_root = opt['path'].get('experiments_root')
        if experiments_root is None:
            experiments_root = osp.join(root_path, 'experiments')
        experiments_root = osp.join(experiments_root, opt['name'])
        opt['path']['experiments_root'] = experiments_root
        opt['path']['models'] = osp.join(experiments_root, 'models')
        opt['path']['training_states'] = osp.join(experiments_root,
                                                  'training_states')
        opt['path']['log'] = experiments_root
        opt['path']['visualization'] = osp.join(experiments_root,
                                                'visualization')
        if 'debug' in opt['name']:
            if 'val' in opt:
                opt['val']['val_freq'] = 8
            opt['logger']['print_freq'] = 1
            opt['logger']['save_checkpoint_freq'] = 8
    else:
        results_root = opt['path'].get('results_root')
        if results_root is None:
            results_root = osp.join(root_path, 'results')
        results_root = osp.join(results_root, opt['name'])
        opt['path']['results_root'] = results_root
        opt['path']['log'] = results_root
        opt['path']['visualization'] = osp.join(results_root,
                                                'visualization')
    return opt, args


@master_only
def copy_opt_file(opt_file, experiments_root):
    """Copy the YAML into the experiment's directory with the time and
    the command line on top (reference options.py:181-195)."""
    import time
    from shutil import copyfile
    cmd = ' '.join(sys.argv)
    filename = osp.join(experiments_root, osp.basename(opt_file))
    copyfile(opt_file, filename)
    with open(filename, 'r+') as f:
        lines = f.readlines()
        lines.insert(0,
                     f'# GENERATE TIME: {time.asctime()}\n# CMD:\n# {cmd}\n\n')
        f.seek(0)
        f.writelines(lines)
