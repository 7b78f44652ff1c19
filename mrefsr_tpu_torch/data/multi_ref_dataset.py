"""Multi-reference datasets: LMR's MegaDepth training set and the CUFED5
eval set (port of ``mrefsr_tpu/data/multi_ref_dataset.py``, the
reference's ``basicsr/data/multi_ref_dataset.py``).

Samples are HWC RGB numpy arrays, the refs stacked on a leading axis of 5,
as the JAX package's. Images decode with Pillow (the training set) and
OpenCV (CUFED5), both imported where they are used, and are resampled with
Pillow's uint8 bicubic: that degradation defines the training data. The
LMR annotation CSV is read with the standard ``csv`` module; scene names
stay strings (leading zeros kept), as the JAX package's
``dtype={'scene': 'string'}`` keeps them.
"""
import csv
import glob
import os.path as osp
import random
import threading
from ast import literal_eval
from collections import OrderedDict

import numpy as np

from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_util import match_point_crop
from .transforms import augment, mod_crop

# the values of a training set's output_dtype (unset: float32)
OUTPUT_DTYPES = (None, 'float32', 'uint8')


def _impad_to(img, shape, pad_val=0):
    """``img`` zero-padded at the bottom and right to ``shape`` (h, w)
    (mmcv's ``impad``, reference multi_ref_dataset.py:175-180); a dimension
    larger than the target is first cropped from the top left, which only
    bucketed ``pad_to`` canvases reach."""
    img = img[:shape[0], :shape[1]]
    h, w = img.shape[:2]
    return np.pad(img, ((0, shape[0] - h), (0, shape[1] - w), (0, 0)),
                  constant_values=pad_val)


def _pil_resize(img_u8, size_wh):
    """Pillow's uint8 bicubic resize of an HWC uint8 array to ``size_wh``."""
    from PIL import Image
    return np.array(Image.fromarray(img_u8).resize(size_wh, Image.BICUBIC))


def _pil_down_up_u8(img_u8, scale):
    """Pillow's uint8 bicubic down by ``scale`` and back up: the pair
    ``(lq, up)`` of the reference's degradation (multi_ref_dataset.py:
    93-113), uint8 in and out."""
    h, w = img_u8.shape[:2]
    lq = _pil_resize(img_u8, (w // scale, h // scale))
    return lq, _pil_resize(lq, (w, h))


@DATASET_REGISTRY.register()
class MultiRefMegaDepthDataset:
    """The 5-reference MegaDepth training set (reference
    multi_ref_dataset.py:20-139).

    Each sample crops the target and its 5 refs around their annotated
    match points to ``gt_size``, shuffles the refs, flips and transposes
    all six alike (``use_flip``, ``use_rot``) and degrades each by
    Pillow's bicubic down x ``scale`` and back up. It returns
    ``img_in``, ``img_in_lq``, ``img_in_up``, ``img_ref_list``,
    ``img_ref_lq_list`` and ``img_ref_up_list``: RGB float32 in [0, 1], or
    with ``output_dtype: uint8`` the same pixels as uint8, for the device
    to divide by 255 (``data/prefetch_dataloader.py``).

    The random draws come from ``random.Random(seed)``, in the order of the
    JAX package's draws from python's global generator, so one seed gives
    both packages the same samples. ``decode_cache_size`` (default 0,
    off) keeps that many decoded images in an LRU cache shared by the
    loader's threads: the pipeline is decode-bound (six decodes a sample)
    and each image comes back about ``dataset_enlarge_ratio`` times an
    epoch.
    """

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.in_folder = opt['dataroot_in']
        self.ref_folder = opt['dataroot_ref']
        self.ann_file = opt['ann_file']
        self.output_dtype = opt.get('output_dtype')
        if self.output_dtype not in OUTPUT_DTYPES:
            raise ValueError(f'output_dtype is uint8, float32 or unset, got '
                             f'{self.output_dtype!r}')
        self.load_annotations()
        self._cache_size = int(opt.get('decode_cache_size', 0))
        self._cache = OrderedDict()
        self._cache_lock = threading.Lock()

    def load_annotations(self):
        """``samples``: (target path, 5 ref paths, target point, 5 ref
        points) per row of the CSV, whose columns are target, H, M1, M2,
        L1, L2, p0 ... p5, scene (the header row names them)."""
        self.samples = []
        with open(self.ann_file, newline='') as f:
            rows = csv.reader(f)
            next(rows)
            for row in rows:
                (target, h, m1, m2, l1, l2, p0, p1, p2, p3, p4, p5,
                 scene) = row
                target = osp.join(self.in_folder, scene, target)
                references = [osp.join(self.in_folder, scene, name)
                              for name in (h, m1, m2, l1, l2)]
                p_refs = [np.array(literal_eval(p))
                          for p in (p1, p2, p3, p4, p5)]
                self.samples.append((target, references,
                                     np.array(literal_eval(p0)), p_refs))

    def _load_u8(self, path):
        """The image at ``path`` as uint8 RGB, through the LRU cache where
        it is on (a cached image is read-only)."""
        from PIL import Image
        if not self._cache_size:
            return np.array(Image.open(path).convert('RGB'))
        with self._cache_lock:
            img = self._cache.get(path)
            if img is not None:
                self._cache.move_to_end(path)
                return img
        img = np.array(Image.open(path).convert('RGB'))
        img.setflags(write=False)
        with self._cache_lock:
            self._cache[path] = img
            self._cache.move_to_end(path)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return img

    def __getitem__(self, index):
        scale = self.opt['scale']
        in_path, ref_paths, p0, p_refs = self.samples[index]
        # crop the uint8 images before any float copy: /255 after the crop
        # gives the same values for a sixth of the host's work
        gt_h = gt_w = self.opt['gt_size']
        img_in = match_point_crop(self._load_u8(in_path), p0, gt_h, gt_w)
        refs = [match_point_crop(self._load_u8(p), pt, gt_h, gt_w)
                for p, pt in zip(ref_paths, p_refs)]
        self.rng.shuffle(refs)
        imgs = augment([img_in] + refs, self.opt['use_flip'],
                       self.opt['use_rot'], rng=self.rng)
        img_in, refs = imgs[0], imgs[1:]

        img_in_lq, img_in_up = _pil_down_up_u8(img_in, scale)
        refs_lq, refs_up = zip(*(_pil_down_up_u8(r, scale) for r in refs))
        u8_out = self.output_dtype == 'uint8'

        def out(img):
            img = np.ascontiguousarray(img)
            return img if u8_out else img.astype(np.float32) / 255.

        return {
            'img_in': out(img_in),
            'img_in_lq': out(img_in_lq),
            'img_in_up': out(img_in_up),
            'img_ref_list': np.stack([out(r) for r in refs]),
            'img_ref_lq_list': np.stack([out(r) for r in refs_lq]),
            'img_ref_up_list': np.stack([out(r) for r in refs_up]),
        }

    def __len__(self):
        return len(self.samples)


@DATASET_REGISTRY.register()
class MultiRefCUFEDSet:
    """The CUFED5 5-reference eval set (reference
    multi_ref_dataset.py:143-227): inputs ``*_0.png``, refs ``*_1.png`` to
    ``*_5.png``, mod-cropped to ``scale``, then zero-padded at the bottom
    and right to the canvas, degraded by Pillow's bicubic down and up, RGB
    float32 in [0, 1]. ``img_in`` is the unpadded input; ``padding`` and
    ``original_size`` let validation un-pad the output; ``lq_path`` names
    the image.

    ``pad_to`` (default 500, the reference's canvas) is the canvas side. A
    list (``pad_to: [332, 416, 500]``) pads each dimension to the smallest
    listed size it fits, so a 500x332 image takes a 500x332 canvas; refs
    are padded or cropped to the input's canvas. ``seed`` is accepted for
    :func:`~mrefsr_tpu_torch.data.build_dataset`; nothing here is drawn at
    random."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        pad_opt = opt.get('pad_to', 500)
        if isinstance(pad_opt, (list, tuple)):
            self.pad_buckets = sorted(int(v) for v in pad_opt)
        else:
            self.pad_buckets = [int(pad_opt)]
        scale = int(opt.get('scale', 4))
        for b in self.pad_buckets:
            if b % scale:
                raise ValueError(
                    f'pad_to canvas {b} must be divisible by scale '
                    f'{scale} (the LQ canvas is pad_to/scale)')
        root_in, root_ref = opt['dataroot_in'], opt['dataroot_ref']
        self.input_list = sorted(glob.glob(osp.join(root_in, '*_0.png')))
        self.ref_lists = [sorted(glob.glob(osp.join(root_ref, f'*_{i}.png')))
                          for i in range(1, 6)]

    def __len__(self):
        return len(self.input_list)

    def __getitem__(self, idx):
        import cv2
        scale = self.opt['scale']
        img_in = cv2.imread(self.input_list[idx])
        refs = [cv2.imread(lst[idx]) for lst in self.ref_lists]
        ref_path = self.ref_lists[0][idx].replace('_1.png', '_multi.png')

        img_in = mod_crop(img_in, scale)
        img_in_gt = img_in.copy()
        img_in_h, img_in_w = img_in.shape[:2]
        gt_h = next((b for b in self.pad_buckets if b >= img_in_h),
                    self.pad_buckets[-1])
        gt_w = next((b for b in self.pad_buckets if b >= img_in_w),
                    self.pad_buckets[-1])
        img_in = _impad_to(img_in, (gt_h, gt_w))
        refs = [_impad_to(r, (gt_h, gt_w)) for r in refs]

        # the resize is per channel, so on the BGR arrays as the reference
        # (:183-193), before the division by 255 and the swap to RGB
        lq_wh = (gt_w // scale, gt_h // scale)
        img_in_lq = _pil_resize(img_in, lq_wh)
        img_in_up = _pil_resize(img_in_lq, (gt_w, gt_h))
        refs_lq = [_pil_resize(r, lq_wh) for r in refs]
        refs_up = [_pil_resize(r, (gt_w, gt_h)) for r in refs_lq]

        def rgb01(img):
            return np.ascontiguousarray(
                img[:, :, ::-1].astype(np.float32) / 255.)

        return {
            'img_in': rgb01(img_in_gt),
            'img_in_lq': rgb01(img_in_lq),
            'img_in_up': rgb01(img_in_up),
            'img_ref_list': np.stack([rgb01(r) for r in refs]),
            'img_ref_lq_list': np.stack([rgb01(r) for r in refs_lq]),
            'img_ref_up_list': np.stack([rgb01(r) for r in refs_up]),
            'lq_path': ref_path,
            'padding': True,
            'original_size': (img_in_h, img_in_w),
        }
