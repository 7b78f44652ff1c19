"""REDS training sets (port of ``mrefsr_tpu/data/reds_dataset.py``, the
reference's basicsr/data/reds_dataset.py): HWC RGB float32 samples in
[0, 1], ``lq`` a (T, h, w, 3) stack, ``gt`` the centre frame (h, w, 3)
(``REDSDataset``) or a (T, h, w, 3) stack (``REDSRecurrentDataset``).

The random draws (interval, window, reverse, crop, flips) come from the
dataset's own ``random.Random(seed)``, in the order of the JAX package's
draws from python's global generator, so one seed gives both packages the
same samples. REDS clips hold 100 frames, which the windows' bounds assume
(``CLIP_FRAMES``), as the reference's do. ``REDSDataset`` also reads the
quantized flows of ``dataroot_flow`` (the ``flow`` client key), as the
JAX package's does."""
import random
from pathlib import Path

import numpy as np

from mrefsr_tpu_torch.utils import imfrombytes, img2tensor
from mrefsr_tpu_torch.utils.file_client import ensure_file_client
from mrefsr_tpu_torch.utils.flow_util import dequantize_flow
from mrefsr_tpu_torch.utils.logger import get_root_logger
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .transforms import augment, paired_random_crop

CLIP_FRAMES = 100


def _val_partition(name):
    """The clips a partition holds out for validation."""
    if name == 'REDS4':
        return ['000', '011', '015', '020']
    if name == 'official':
        return [f'{v:03d}' for v in range(240, 270)]
    raise ValueError(f'Wrong validation partition {name}.'
                     "Supported ones are ['official', 'REDS4'].")


def _meta_keys(meta_info_file):
    """``<clip>/<frame:08d>`` for every frame of every clip the meta-info
    file lists (``<clip> <frames> <shape>`` a line)."""
    keys = []
    with open(meta_info_file) as fin:
        for line in fin:
            folder, frame_num, _ = line.split(' ')
            keys.extend(f'{folder}/{i:08d}' for i in range(int(frame_num)))
    return keys


class _REDSBase:
    """Keys, the file client and the frame reader shared by both sets."""

    def __init__(self, opt, seed):
        self.opt = opt
        self.rng = random.Random(seed)
        self.gt_root = Path(opt['dataroot_gt'])
        self.lq_root = Path(opt['dataroot_lq'])
        self.keys = _meta_keys(opt['meta_info_file'])
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.is_lmdb = self.io_backend_opt['type'] == 'lmdb'
        if self.is_lmdb:
            self.io_backend_opt['db_paths'] = [self.lq_root, self.gt_root]
            self.io_backend_opt['client_keys'] = ['lq', 'gt']

    def _read(self, kind, clip, frame):
        """Frame ``frame`` of ``clip`` from the ``lq`` or ``gt`` root, BGR
        float32 in [0, 1]; returns it and its path or key."""
        if self.is_lmdb:
            path = f'{clip}/{frame:08d}'
        else:
            root = self.lq_root if kind == 'lq' else self.gt_root
            path = root / clip / f'{frame:08d}.png'
        return imfrombytes(self.file_client.get(path, kind),
                           float32=True), path

    def __len__(self):
        return len(self.keys)


@DATASET_REGISTRY.register()
class REDSDataset(_REDSBase):
    """Sliding windows of ``num_frame`` lq frames around a centre frame and
    its gt (reference reds_dataset.py:14-210): the clips of
    ``val_partition`` left out, the frames ``interval`` apart (drawn from
    ``interval_list``), the window moved inside the clip where it would
    cross an end, reversed with probability 1/2 under
    ``random_reverse``; then one crop and one flip / transpose draw for
    all. With ``dataroot_flow`` the sample also holds ``flow``, (T, h, w,
    2): the quantized flows of the centre frame to its previous neighbours,
    then to its next ones, zeros at the centre."""

    def __init__(self, opt, seed=None):
        super().__init__(opt, seed)
        self.flow_root = (Path(opt['dataroot_flow'])
                          if opt.get('dataroot_flow') is not None else None)
        if self.is_lmdb and self.flow_root is not None:
            self.io_backend_opt['db_paths'].append(self.flow_root)
            self.io_backend_opt['client_keys'].append('flow')
        if opt['num_frame'] % 2 != 1:
            raise ValueError(f'num_frame should be odd number, but got '
                             f'{opt["num_frame"]}')
        self.num_frame = opt['num_frame']
        self.num_half_frames = opt['num_frame'] // 2
        held_out = _val_partition(opt['val_partition'])
        self.keys = [v for v in self.keys if v.split('/')[0] not in held_out]
        self.interval_list = opt['interval_list']
        self.random_reverse = opt['random_reverse']
        get_root_logger().info(
            f'Temporal augmentation interval list: '
            f'[{",".join(str(x) for x in self.interval_list)}]; random '
            f'reverse is {self.random_reverse}.')

    def __getitem__(self, index):
        ensure_file_client(self)
        rng, half = self.rng, self.num_half_frames
        key = self.keys[index]
        clip_name, frame_name = key.split('/')
        center = int(frame_name)
        interval = rng.choice(self.interval_list)
        start, end = center - half * interval, center + half * interval
        while start < 0 or end > CLIP_FRAMES - 1:
            center = rng.randint(0, CLIP_FRAMES - 1)
            start, end = center - half * interval, center + half * interval
        neighbor_list = list(range(start, end + 1, interval))
        if self.random_reverse and rng.random() < 0.5:
            neighbor_list.reverse()
        img_gt, img_gt_path = self._read('gt', clip_name, center)
        img_lqs = [self._read('lq', clip_name, n)[0] for n in neighbor_list]
        flows = None if self.flow_root is None else self._flows(clip_name,
                                                                center)
        img_gt, img_lqs = paired_random_crop(
            img_gt, img_lqs + (flows or []), self.opt['gt_size'],
            self.opt['scale'], img_gt_path, rng=rng)
        if flows is not None:
            img_lqs, flows = img_lqs[:self.num_frame], img_lqs[self.num_frame:]
        img_lqs.append(img_gt)
        if flows is None:
            img_lqs = augment(img_lqs, self.opt['use_hflip'],
                              self.opt['use_rot'], rng=rng)
        else:
            img_lqs, flows = augment(img_lqs, self.opt['use_hflip'],
                                     self.opt['use_rot'], flows, rng=rng)
        results = img2tensor(img_lqs)
        out = {'lq': np.stack(results[:-1], axis=0), 'gt': results[-1],
               'key': key}
        if flows is not None:
            flows.insert(half, np.zeros_like(flows[0]))
            out['flow'] = np.stack([f.astype(np.float32) for f in flows], 0)
        return out

    def _flows(self, clip, center):
        """The dequantized flows of frame ``center``: to its previous
        neighbours, nearest last, then to its next ones, nearest first."""
        half = self.num_half_frames
        flows = []
        for tag, steps in (('p', range(half, 0, -1)),
                           ('n', range(1, half + 1))):
            for i in steps:
                name = f'{center:08d}_{tag}{i}'
                path = (f'{clip}/{name}' if self.is_lmdb
                        else self.flow_root / clip / f'{name}.png')
                cat_flow = imfrombytes(self.file_client.get(path, 'flow'),
                                       flag='grayscale')
                dx, dy = np.split(cat_flow, 2, axis=0)
                flows.append(dequantize_flow(dx, dy, max_val=20,
                                             denorm=False))
        return flows


@DATASET_REGISTRY.register()
class REDSRecurrentDataset(_REDSBase):
    """``num_frame`` consecutive lq and gt frames, ``interval`` apart,
    from a start frame moved back into the clip where the run would cross
    its end (reference reds_dataset.py:213-360); ``test_mode`` keeps the
    clips of ``val_partition`` instead of leaving them out."""

    def __init__(self, opt, seed=None):
        super().__init__(opt, seed)
        self.num_frame = opt['num_frame']
        held_out = _val_partition(opt['val_partition'])
        keep = bool(opt.get('test_mode'))
        self.keys = [v for v in self.keys
                     if (v.split('/')[0] in held_out) == keep]
        self.interval_list = opt.get('interval_list', [1])
        self.random_reverse = opt.get('random_reverse', False)

    def __getitem__(self, index):
        ensure_file_client(self)
        rng = self.rng
        key = self.keys[index]
        clip_name, frame_name = key.split('/')
        interval = rng.choice(self.interval_list)
        span = self.num_frame * interval
        start = int(frame_name)
        if start > CLIP_FRAMES - span:
            start = rng.randint(0, CLIP_FRAMES - span)
        neighbor_list = list(range(start, start + span, interval))
        if self.random_reverse and rng.random() < 0.5:
            neighbor_list.reverse()
        img_lqs, img_gts = [], []
        for neighbor in neighbor_list:
            img_lqs.append(self._read('lq', clip_name, neighbor)[0])
            img_gt, img_gt_path = self._read('gt', clip_name, neighbor)
            img_gts.append(img_gt)
        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs,
                                              self.opt['gt_size'],
                                              self.opt['scale'], img_gt_path,
                                              rng=rng)
        img_lqs.extend(img_gts)
        results = img2tensor(augment(img_lqs, self.opt['use_hflip'],
                                     self.opt['use_rot'], rng=rng))
        n = len(results) // 2
        return {'lq': np.stack(results[:n], axis=0),
                'gt': np.stack(results[n:], axis=0), 'key': key}
