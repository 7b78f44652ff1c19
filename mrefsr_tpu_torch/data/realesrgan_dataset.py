"""Real-ESRGAN's datasets (port of ``mrefsr_tpu/data/realesrgan_dataset.py``,
the reference's basicsr/data/realesrgan_dataset.py and
realesrgan_paired_dataset.py).

:class:`RealESRGANDataset` reads a gt image, flips it, reflect-pads or
crops it to ``crop_pad_size`` and draws its three 21 x 21 kernels (the
first and second blur, the final sinc or a pulse); the model degrades it
on the card (``models/degradation_synth.py``). :class:`RealESRGANPairedDataset`
reads ``lq`` / ``gt`` pairs (validation, ``high_order_degradation:
false``). The draws come from the dataset's own ``random.Random(seed)``
and ``numpy.random.RandomState(seed)``, in the JAX package's order, where
it draws from python's and numpy's global generators. Samples are HWC RGB
float32 in [0, 1]."""
import logging
import math
import os
import os.path as osp
import random
import time

import numpy as np

from mrefsr_tpu_torch.utils import imfrombytes, img2tensor
from mrefsr_tpu_torch.utils.file_client import ensure_file_client
from mrefsr_tpu_torch.utils.misc import scandir
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_util import paired_paths_from_folder, paired_paths_from_lmdb
from .degradations import circular_lowpass_kernel, random_mixed_kernels
from .transforms import augment, paired_random_crop

logger = logging.getLogger(__name__)


@DATASET_REGISTRY.register()
class RealESRGANDataset:
    """gt images and their degradation kernels (reference
    realesrgan_dataset.py:18-193): paths from an lmdb folder, a
    ``meta_info`` file or the folder ``dataroot_gt``."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.gt_folder = opt['dataroot_gt']
        if self.io_backend_opt['type'] == 'lmdb':
            self.io_backend_opt['db_paths'] = [self.gt_folder]
            self.io_backend_opt['client_keys'] = ['gt']
            if not self.gt_folder.endswith('.lmdb'):
                raise ValueError(
                    f"'dataroot_gt' should end with '.lmdb', but received "
                    f'{self.gt_folder}')
            with open(osp.join(self.gt_folder, 'meta_info.txt')) as fin:
                self.paths = [line.split('.')[0] for line in fin]
        elif opt.get('meta_info') is not None:
            with open(opt['meta_info']) as fin:
                self.paths = [os.path.join(self.gt_folder,
                                           line.strip().split(' ')[0])
                              for line in fin]
        else:
            self.paths = sorted(osp.join(self.gt_folder, v)
                                for v in scandir(self.gt_folder))
        # the two blurs' settings (reference :59-75)
        self.stages = [
            {k: opt[k + suffix] for k in ('kernel_list', 'kernel_prob',
                                          'blur_sigma', 'betag_range',
                                          'betap_range', 'sinc_prob')}
            for suffix in ('', '2')]
        self.final_sinc_prob = opt['final_sinc_prob']
        self.kernel_range = [2 * v + 1 for v in range(3, 11)]  # 7 ... 21
        self.pulse_tensor = np.zeros((21, 21), np.float32)
        self.pulse_tensor[10, 10] = 1

    def _sample_kernel(self, stage):
        """A sinc (with probability ``sinc_prob``) or a mixed kernel of a
        random odd size in [7, 21], zero-padded to 21 x 21 (reference
        :128-152)."""
        kernel_size = self.rng.choice(self.kernel_range)
        if self.np_rng.uniform() < stage['sinc_prob']:
            low = np.pi / 3 if kernel_size < 13 else np.pi / 5
            kernel = circular_lowpass_kernel(
                self.np_rng.uniform(low, np.pi), kernel_size, pad_to=False)
        else:
            kernel = random_mixed_kernels(
                stage['kernel_list'], stage['kernel_prob'], kernel_size,
                stage['blur_sigma'], stage['blur_sigma'],
                [-math.pi, math.pi], stage['betag_range'],
                stage['betap_range'], noise_range=None, rng=self.rng,
                np_rng=self.np_rng)
        pad_size = (21 - kernel_size) // 2
        return np.pad(kernel, ((pad_size, pad_size), (pad_size, pad_size)))

    def _read(self, index):
        """The gt image of ``index`` and its path; a failed read retries
        twice on other random indices, a second apart."""
        gt_path, last_err = self.paths[index], None
        for retry in range(3, 0, -1):
            try:
                return self.file_client.get(gt_path, 'gt'), gt_path
            except (IOError, OSError) as err:
                last_err = err
                logger.warning(f'File client error: {err}, remaining retry '
                               f'times: {retry - 1}')
                gt_path = self.paths[self.rng.randint(0, len(self) - 1)]
                time.sleep(1)
        raise IOError(f'Failed to read a training image after retries '
                      f'(last: {gt_path})') from last_err

    def __getitem__(self, index):
        import cv2
        ensure_file_client(self)
        img_bytes, gt_path = self._read(index)
        img_gt = augment(imfrombytes(img_bytes, float32=True),
                         self.opt['use_hflip'], self.opt['use_rot'],
                         rng=self.rng)
        # crop or pad to crop_pad_size (reference :111-127)
        h, w = img_gt.shape[0:2]
        size = self.opt.get('crop_pad_size', 400)
        if h < size or w < size:
            img_gt = cv2.copyMakeBorder(img_gt, 0, max(0, size - h), 0,
                                        max(0, size - w),
                                        cv2.BORDER_REFLECT_101)
        if img_gt.shape[0] > size or img_gt.shape[1] > size:
            h, w = img_gt.shape[0:2]
            top = self.rng.randint(0, h - size)
            left = self.rng.randint(0, w - size)
            img_gt = img_gt[top:top + size, left:left + size, ...]
        kernel1 = self._sample_kernel(self.stages[0])
        kernel2 = self._sample_kernel(self.stages[1])
        # the final sinc kernel (reference :175-181)
        if self.np_rng.uniform() < self.final_sinc_prob:
            kernel_size = self.rng.choice(self.kernel_range)
            sinc_kernel = circular_lowpass_kernel(
                self.np_rng.uniform(np.pi / 3, np.pi), kernel_size,
                pad_to=21)
        else:
            sinc_kernel = self.pulse_tensor
        return {'gt': img2tensor(img_gt, bgr2rgb=True, float32=True),
                'kernel1': kernel1.astype(np.float32),
                'kernel2': kernel2.astype(np.float32),
                'sinc_kernel': sinc_kernel.astype(np.float32),
                'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class RealESRGANPairedDataset:
    """``lq`` / ``gt`` pairs from an lmdb pair, a ``meta_info`` file of
    ``gt, lq`` lines or two folders (reference
    realesrgan_paired_dataset.py:12-106); ``phase: train`` crops
    ``gt_size`` at matching places and flips both alike."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.mean, self.std = opt.get('mean'), opt.get('std')
        self.gt_folder, self.lq_folder = opt['dataroot_gt'], opt['dataroot_lq']
        self.filename_tmpl = opt.get('filename_tmpl', '{}')
        if self.io_backend_opt['type'] == 'lmdb':
            self.io_backend_opt['db_paths'] = [self.lq_folder, self.gt_folder]
            self.io_backend_opt['client_keys'] = ['lq', 'gt']
            self.paths = paired_paths_from_lmdb(
                [self.lq_folder, self.gt_folder], ['lq', 'gt'])
        elif opt.get('meta_info') is not None:
            self.paths = []
            with open(opt['meta_info']) as fin:
                for line in fin:
                    gt_path, lq_path = line.strip().split(', ')
                    self.paths.append(
                        {'gt_path': os.path.join(self.gt_folder, gt_path),
                         'lq_path': os.path.join(self.lq_folder, lq_path)})
        else:
            self.paths = paired_paths_from_folder(
                [self.lq_folder, self.gt_folder], ['lq', 'gt'],
                self.filename_tmpl)

    def __getitem__(self, index):
        ensure_file_client(self)
        gt_path = self.paths[index]['gt_path']
        lq_path = self.paths[index]['lq_path']
        img_gt = imfrombytes(self.file_client.get(gt_path, 'gt'),
                             float32=True)
        img_lq = imfrombytes(self.file_client.get(lq_path, 'lq'),
                             float32=True)
        if self.opt['phase'] == 'train':
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, self.opt['gt_size'], self.opt['scale'],
                gt_path, rng=self.rng)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt['use_hflip'],
                                     self.opt['use_rot'], rng=self.rng)
        img_gt, img_lq = img2tensor([img_gt, img_lq], bgr2rgb=True,
                                    float32=True)
        if self.mean is not None or self.std is not None:
            mean = np.asarray(self.mean, np.float32)
            std = np.asarray(self.std, np.float32)
            img_lq, img_gt = (img_lq - mean) / std, (img_gt - mean) / std
        return {'lq': img_lq, 'gt': img_gt, 'lq_path': lq_path,
                'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)
