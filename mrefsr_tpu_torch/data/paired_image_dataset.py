"""Paired and single image sets, ``SRModel``'s data (port of
``mrefsr_tpu/data/paired_image_dataset.py``, the reference's
basicsr/data/paired_image_dataset.py and single_image_dataset.py): HWC RGB
float32 in [0, 1] (or the Y channel with ``color: y``), normalised by
``mean`` / ``std`` where given. Paths from an lmdb pair, a pair of packed
shards (``io_backend: {type: pack}``, the dataroots naming the ``.pack``
files), a meta-info file or two folders. Training crops and flips draw
from the dataset's own ``random.Random(seed)``, in the JAX package's
order."""
import os.path as osp
import random

import numpy as np

from mrefsr_tpu_torch.utils import imfrombytes, img2tensor
from mrefsr_tpu_torch.utils.color_util import rgb2ycbcr
from mrefsr_tpu_torch.utils.file_client import ensure_file_client
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_util import (paired_paths_from_folder, paired_paths_from_lmdb,
                        paired_paths_from_meta_info_file,
                        paired_paths_from_pack, paths_from_folder,
                        paths_from_lmdb, paths_from_pack)
from .transforms import augment, paired_random_crop


def _normalise(img, mean, std):
    if mean is None and std is None:
        return img
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@DATASET_REGISTRY.register()
class PairedImageDataset:
    """``lq`` / ``gt`` pairs (reference paired_image_dataset.py:11-110);
    ``phase: train`` crops ``gt_size`` at matching places and flips /
    transposes both alike, other phases crop gt to ``scale`` times lq."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.mean, self.std = opt.get('mean'), opt.get('std')
        self.gt_folder, self.lq_folder = opt['dataroot_gt'], opt['dataroot_lq']
        self.filename_tmpl = opt.get('filename_tmpl', '{}')
        folders, keys = [self.lq_folder, self.gt_folder], ['lq', 'gt']
        if self.io_backend_opt['type'] in ('lmdb', 'pack'):
            self.io_backend_opt['db_paths'] = folders
            self.io_backend_opt['client_keys'] = keys
            self.paths = (paired_paths_from_lmdb(folders, keys)
                          if self.io_backend_opt['type'] == 'lmdb'
                          else paired_paths_from_pack(folders, keys))
        elif opt.get('meta_info_file') is not None:
            self.paths = paired_paths_from_meta_info_file(
                folders, keys, opt['meta_info_file'], self.filename_tmpl)
        else:
            self.paths = paired_paths_from_folder(folders, keys,
                                                  self.filename_tmpl)

    def __getitem__(self, index):
        ensure_file_client(self)
        scale = self.opt['scale']
        gt_path = self.paths[index]['gt_path']
        lq_path = self.paths[index]['lq_path']
        img_gt = imfrombytes(self.file_client.get(gt_path, 'gt'),
                             float32=True)
        img_lq = imfrombytes(self.file_client.get(lq_path, 'lq'),
                             float32=True)
        if self.opt['phase'] == 'train':
            img_gt, img_lq = paired_random_crop(img_gt, img_lq,
                                                self.opt['gt_size'], scale,
                                                gt_path, rng=self.rng)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt['use_hflip'],
                                     self.opt['use_rot'], rng=self.rng)
        if self.opt.get('color') == 'y':
            # on the BGR arrays, as the reference calls it
            img_gt = rgb2ycbcr(img_gt, y_only=True)[..., None]
            img_lq = rgb2ycbcr(img_lq, y_only=True)[..., None]
        if self.opt['phase'] != 'train':
            img_gt = img_gt[0:img_lq.shape[0] * scale,
                            0:img_lq.shape[1] * scale, :]
        img_gt, img_lq = img2tensor([img_gt, img_lq])
        return {'lq': _normalise(img_lq, self.mean, self.std),
                'gt': _normalise(img_gt, self.mean, self.std),
                'lq_path': lq_path, 'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class SingleImageDataset:
    """``lq`` images alone, for ``test.py`` without gt (reference
    single_image_dataset.py:11-68)."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.mean, self.std = opt.get('mean'), opt.get('std')
        self.lq_folder = opt['dataroot_lq']
        if self.io_backend_opt['type'] in ('lmdb', 'pack'):
            self.io_backend_opt['db_paths'] = [self.lq_folder]
            self.io_backend_opt['client_keys'] = ['lq']
            self.paths = (paths_from_lmdb(self.lq_folder)
                          if self.io_backend_opt['type'] == 'lmdb'
                          else paths_from_pack(self.lq_folder))
        elif opt.get('meta_info_file') is not None:
            with open(opt['meta_info_file']) as fin:
                self.paths = [osp.join(self.lq_folder,
                                       line.rstrip().split(' ')[0])
                              for line in fin]
        else:
            self.paths = sorted(paths_from_folder(self.lq_folder))

    def __getitem__(self, index):
        ensure_file_client(self)
        lq_path = self.paths[index]
        img_lq = imfrombytes(self.file_client.get(lq_path, 'lq'),
                             float32=True)
        if self.opt.get('color') == 'y':
            img_lq = rgb2ycbcr(img_lq, y_only=True)[..., None]
        return {'lq': _normalise(img2tensor(img_lq), self.mean, self.std),
                'lq_path': lq_path}

    def __len__(self):
        return len(self.paths)
