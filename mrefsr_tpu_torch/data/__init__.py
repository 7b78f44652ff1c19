"""The port's data pipeline (port of ``mrefsr_tpu/data``): the registered
datasets (every ``*_dataset.py`` here registers its own; so far the
multi-ref LMR and CUFED5 sets), the rank-sharded sampler, the threaded
loader and the prefetchers that put batches on the device. Everything here
is numpy on the host but the device prefetchers; Pillow and OpenCV are
imported where an image is read."""
import importlib
from copy import deepcopy
from pathlib import Path

from mrefsr_tpu_torch.utils.logger import get_root_logger
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_sampler import EnlargedSampler
from .loader import DataLoader, default_collate
from .prefetch_dataloader import (BackgroundDevicePrefetcher, CPUPrefetcher,
                                  CUDAPrefetcher, uint8_to_float32)

__all__ = ['BackgroundDevicePrefetcher', 'CPUPrefetcher', 'CUDAPrefetcher',
           'DataLoader', 'EnlargedSampler', 'build_dataloader',
           'build_dataset', 'default_collate', 'uint8_to_float32']

for _path in sorted(Path(__file__).parent.glob('*_dataset.py')):
    importlib.import_module(f'{__name__}.{_path.stem}')


def build_dataset(dataset_opt, seed=None):
    """The registered dataset ``dataset_opt['type']``, its random draws
    seeded with ``seed``."""
    dataset_opt = deepcopy(dataset_opt)
    dataset = DATASET_REGISTRY.get(dataset_opt['type'])(dataset_opt,
                                                        seed=seed)
    get_root_logger().info(f'Dataset [{dataset.__class__.__name__}] - '
                           f'{dataset_opt["name"]} is built.')
    return dataset


def build_dataloader(dataset, dataset_opt, sampler=None, seed=None):
    """A loader with the reference's phases (reference data/__init__.py:
    40-94): ``train`` takes ``batch_size_per_gpu`` samples a batch (this
    process's batch), ``num_worker_per_gpu`` threads (default 4), the
    sampler (else a shuffle seeded by ``seed``) and drops a short last
    batch; ``val`` and ``test`` take batches of 1, in order, on the
    caller's thread."""
    phase = dataset_opt['phase']
    if phase == 'train':
        return DataLoader(
            dataset, batch_size=dataset_opt['batch_size_per_gpu'],
            shuffle=sampler is None, sampler=sampler,
            num_workers=dataset_opt.get('num_worker_per_gpu', 4),
            drop_last=True, seed=seed)
    if phase in ('val', 'test'):
        return DataLoader(dataset, batch_size=1, shuffle=False,
                          num_workers=0)
    raise ValueError(f'Wrong dataset phase: {phase}. '
                     "Supported ones are 'train', 'val' and 'test'.")
