"""FFHQ, StyleGAN2's training set (port of ``mrefsr_tpu/data/ffhq_dataset.py``,
the reference's basicsr/data/ffhq_dataset.py:13-77): ``gt`` alone, HWC RGB
float32 normalised by ``mean`` / ``std``, flipped with ``use_hflip``."""
import logging
import os.path as osp
import random
import time

import numpy as np

from mrefsr_tpu_torch.utils import imfrombytes, img2tensor
from mrefsr_tpu_torch.utils.file_client import ensure_file_client
from mrefsr_tpu_torch.utils.misc import scandir
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .transforms import augment

logger = logging.getLogger(__name__)


@DATASET_REGISTRY.register()
class FFHQDataset:
    """The images of ``dataroot_gt``: ``%08d.png`` for ``num_images`` of
    them where that is set, else every file of the folder, sorted; an lmdb
    (``io_backend.type: lmdb``, ``meta_info.txt``) through the file
    client. A failed read retries on another random index, three reads in
    all, a second apart, then raises. Flips and retries draw from the
    dataset's own ``random.Random(seed)``, in the JAX package's order."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.gt_folder = opt['dataroot_gt']
        self.mean = np.asarray(opt['mean'], np.float32)
        self.std = np.asarray(opt['std'], np.float32)
        if self.io_backend_opt['type'] == 'lmdb':
            self.io_backend_opt['db_paths'] = self.gt_folder
            if not self.gt_folder.endswith('.lmdb'):
                raise ValueError("'dataroot_gt' should end with '.lmdb', "
                                 f'but received {self.gt_folder}')
            with open(osp.join(self.gt_folder, 'meta_info.txt')) as fin:
                self.paths = [line.split('.')[0] for line in fin]
        elif opt.get('num_images'):
            self.paths = [osp.join(self.gt_folder, f'{v:08d}.png')
                          for v in range(opt['num_images'])]
        else:
            self.paths = sorted(osp.join(self.gt_folder, v)
                                for v in scandir(self.gt_folder))

    def __getitem__(self, index):
        ensure_file_client(self)
        gt_path = self.paths[index]
        img_bytes, last_err = None, None
        for retry in range(3, 0, -1):
            try:
                img_bytes = self.file_client.get(gt_path)
                break
            except Exception as e:  # noqa: BLE001 (the reference's retry)
                last_err = e
                logger.warning(f'File client error: {e}, remaining retry '
                               f'times: {retry - 1}')
                index = self.rng.randint(0, len(self) - 1)
                gt_path = self.paths[index]
                time.sleep(1)
        if img_bytes is None:
            raise IOError(f'Failed to read a training image after retries '
                          f'(last: {gt_path})') from last_err
        img_gt = augment(imfrombytes(img_bytes, float32=True),
                         hflip=self.opt['use_hflip'], rotation=False,
                         rng=self.rng)
        img_gt = (img2tensor(img_gt) - self.mean) / self.std
        return {'gt': img_gt, 'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)
