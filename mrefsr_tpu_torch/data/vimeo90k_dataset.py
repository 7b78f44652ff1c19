"""Vimeo-90K training sets (port of ``mrefsr_tpu/data/vimeo90k_dataset.py``,
the reference's basicsr/data/vimeo90k_dataset.py): septuplets
``<clip>/<seq>/im{1..7}.png``, HWC RGB float32 in [0, 1]. The random draws
come from the dataset's own ``random.Random(seed)``, in the JAX package's
order."""
import random
from pathlib import Path

import numpy as np

from mrefsr_tpu_torch.utils import imfrombytes, img2tensor
from mrefsr_tpu_torch.utils.file_client import ensure_file_client
from mrefsr_tpu_torch.utils.logger import get_root_logger
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .transforms import augment, paired_random_crop


@DATASET_REGISTRY.register()
class Vimeo90KDataset:
    """``num_frame`` lq frames around ``im4`` and its gt (reference
    vimeo90k_dataset.py:12-127), reversed with probability 1/2 under
    ``random_reverse``; one crop and one flip / transpose draw for all."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.gt_root = Path(opt['dataroot_gt'])
        self.lq_root = Path(opt['dataroot_lq'])
        with open(opt['meta_info_file']) as fin:
            self.keys = [line.split(' ')[0] for line in fin]
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.is_lmdb = self.io_backend_opt['type'] == 'lmdb'
        if self.is_lmdb:
            self.io_backend_opt['db_paths'] = [self.lq_root, self.gt_root]
            self.io_backend_opt['client_keys'] = ['lq', 'gt']
        self.neighbor_list = [i + (9 - opt['num_frame']) // 2
                              for i in range(opt['num_frame'])]
        self.random_reverse = opt['random_reverse']
        get_root_logger().info(f'Random reverse is {self.random_reverse}.')

    def _read(self, kind, clip, seq, neighbor):
        if self.is_lmdb:
            path = f'{clip}/{seq}/im{neighbor}'
        else:
            root = self.lq_root if kind == 'lq' else self.gt_root
            path = root / clip / seq / f'im{neighbor}.png'
        return imfrombytes(self.file_client.get(path, kind),
                           float32=True), path

    def _neighbors(self):
        # a copy: the loader's threads share this dataset
        neighbor_list = list(self.neighbor_list)
        if self.random_reverse and self.rng.random() < 0.5:
            neighbor_list.reverse()
        return neighbor_list

    def __getitem__(self, index):
        ensure_file_client(self)
        neighbor_list = self._neighbors()
        key = self.keys[index]
        clip, seq = key.split('/')
        img_gt, img_gt_path = self._read('gt', clip, seq, 4)
        img_lqs = [self._read('lq', clip, seq, n)[0] for n in neighbor_list]
        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs,
                                             self.opt['gt_size'],
                                             self.opt['scale'], img_gt_path,
                                             rng=self.rng)
        img_lqs.append(img_gt)
        results = img2tensor(augment(img_lqs, self.opt['use_hflip'],
                                     self.opt['use_rot'], rng=self.rng))
        return {'lq': np.stack(results[:-1], axis=0), 'gt': results[-1],
                'key': key}

    def __len__(self):
        return len(self.keys)


@DATASET_REGISTRY.register()
class Vimeo90KRecurrentDataset(Vimeo90KDataset):
    """All 7 frames as lq and gt stacks (reference
    vimeo90k_dataset.py:130-196); ``flip_sequence`` appends them reversed
    (14 frames)."""

    def __init__(self, opt, seed=None):
        super().__init__(opt, seed)
        self.flip_sequence = opt['flip_sequence']
        self.neighbor_list = [1, 2, 3, 4, 5, 6, 7]

    def __getitem__(self, index):
        ensure_file_client(self)
        neighbor_list = self._neighbors()
        key = self.keys[index]
        clip, seq = key.split('/')
        img_lqs, img_gts = [], []
        for neighbor in neighbor_list:
            img_lqs.append(self._read('lq', clip, seq, neighbor)[0])
            img_gt, img_gt_path = self._read('gt', clip, seq, neighbor)
            img_gts.append(img_gt)
        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs,
                                              self.opt['gt_size'],
                                              self.opt['scale'], img_gt_path,
                                              rng=self.rng)
        img_lqs.extend(img_gts)
        results = img2tensor(augment(img_lqs, self.opt['use_hflip'],
                                     self.opt['use_rot'], rng=self.rng))
        img_lqs = np.stack(results[:7], axis=0)
        img_gts = np.stack(results[7:], axis=0)
        if self.flip_sequence:
            img_lqs = np.concatenate([img_lqs, img_lqs[::-1]], axis=0)
            img_gts = np.concatenate([img_gts, img_gts[::-1]], axis=0)
        return {'lq': img_lqs, 'gt': img_gts, 'key': key}
