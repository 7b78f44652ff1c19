"""Single-reference MegaDepth datasets (port of
``mrefsr_tpu/data/ref_megadepth_dataset.py:33-221``, the reference's
``basicsr/data/ref_megadepth_dataset.py`` and ``single_ref_dataset.py``):
RGB float32 samples in [0, 1] (Pillow reads) with Pillow's bicubic
down-and-up chain; the test scenes of the split are fixed.

The random draws come from the dataset's own ``random.Random(seed)``
(the flips) and ``np.random.RandomState(seed)`` (the ref permutation and
the CVT homography), in the order of the JAX package's draws from python's
and numpy's global generators: one seed, the same samples. The annotation
CSVs are read with the ``csv`` module, scene names kept as strings."""
import csv
import os.path as osp
import random
from ast import literal_eval

import numpy as np

from mrefsr_tpu_torch.utils import img2tensor
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_util import match_point_crop
from .multi_ref_dataset import _impad_to
from .ref_cufed_dataset import image_pair_generation_perspective
from .transforms import augment, mod_crop

TEST_SCENES = ['0000', '0003', '0004', '0008', '0013', '0017', '0019',
               '0021', '0024', '0032', '0048', '0050', '0063', '0078',
               '0380', '1589', '5009', '5010', '5012']
SAMPLE_KEYS = ('img_in', 'img_in_lq', 'img_in_up', 'img_ref', 'img_ref_lq',
               'img_ref_up')


def _read_rgb(path):
    from PIL import Image
    return np.array(Image.open(path).convert('RGB')).astype(
        np.float32) / 255.


def _rgb_lq_up(img01, lq_w, lq_h, gt_w, gt_h):
    """Pillow's bicubic down and back up of an RGB [0, 1] image:
    ``(lq, up)``."""
    from PIL import Image
    pil = Image.fromarray((img01 * 255).astype(np.uint8))
    lq = pil.resize((lq_w, lq_h), Image.BICUBIC)
    up = lq.resize((gt_w, gt_h), Image.BICUBIC)
    return (np.array(lq).astype(np.float32) / 255.,
            np.array(up).astype(np.float32) / 255.)


def _rows(ann_file):
    """The CSV's rows as lists of strings, the header row left out."""
    with open(ann_file, newline='') as f:
        rows = csv.reader(f)
        next(rows)
        return list(rows)


def _pack(img_in, img_ref, gt_h, gt_w, scale):
    lq_h, lq_w = gt_h // scale, gt_w // scale
    img_in_lq, img_in_up = _rgb_lq_up(img_in, lq_w, lq_h, gt_w, gt_h)
    img_ref_lq, img_ref_up = _rgb_lq_up(img_ref, lq_w, lq_h, gt_w, gt_h)
    return dict(zip(SAMPLE_KEYS, img2tensor(
        [img_in, img_in_lq, img_in_up, img_ref, img_ref_lq, img_ref_up],
        bgr2rgb=False, float32=True)))


@DATASET_REGISTRY.register()
class RefMegaDepthDataset:
    """Single-ref MegaDepth with match-point crops (reference
    ref_megadepth_dataset.py:16-190). The CSV's columns are target,
    reference, scene, similarity, points of the target, points of the
    reference; rows stop at the first of similarity ``L``. Training takes
    the scenes outside :data:`TEST_SCENES`, one sample per match point,
    cropped to ``gt_size`` around it and flipped; testing the test scenes,
    mod-cropped and zero-padded to a common size."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.in_folder = opt['dataroot_in']
        self.ref_folder = opt['dataroot_ref']
        self.ann_file = opt['ann_file']
        self.load_annotations()

    def load_annotations(self):
        self.samples = []
        train = self.opt['phase'] == 'train'
        for target, reference, scene, sim, p_a, p_b in _rows(self.ann_file):
            if sim == 'L':
                break
            if train == (scene in TEST_SCENES):
                continue
            in_path = osp.join(self.in_folder, scene, target)
            ref_path = osp.join(self.in_folder, scene, reference)
            if train:
                for xy_a, xy_b in zip(np.array(literal_eval(p_a)),
                                      np.array(literal_eval(p_b))):
                    self.samples.append((in_path, ref_path, xy_a, xy_b))
            else:
                self.samples.append((in_path, ref_path, (-1, -1),
                                     (-1, -1)))

    def _load_pair(self, index):
        in_path, ref_path, pt_a, pt_b = self.samples[index]
        return _read_rgb(in_path), _read_rgb(ref_path), pt_a, pt_b, ref_path

    def _train_crop(self, img_in, img_ref, pt_a, pt_b):
        gt = self.opt['gt_size']
        img_in = match_point_crop(img_in, pt_a, gt, gt)
        img_ref = match_point_crop(img_ref, pt_b, gt, gt)
        return augment([img_in, img_ref], self.opt['use_flip'],
                       self.opt['use_rot'], rng=self.rng)

    def __getitem__(self, index):
        scale = self.opt['scale']
        img_in, img_ref, pt_a, pt_b, ref_path = self._load_pair(index)
        if self.opt['phase'] == 'train':
            img_in, img_ref = self._train_crop(img_in, img_ref, pt_a, pt_b)
            gt = self.opt['gt_size']
            return _pack(img_in, img_ref, gt, gt, scale)
        img_in = mod_crop(img_in, scale)
        img_in_gt = img_in.copy()
        img_ref = mod_crop(img_ref, scale)
        (in_h, in_w), (ref_h, ref_w) = img_in.shape[:2], img_ref.shape[:2]
        padding = (in_h, in_w) != (ref_h, ref_w)
        if padding:
            target = (max(in_h, ref_h), max(in_w, ref_w))
            img_in = _impad_to(img_in, target)
            img_ref = _impad_to(img_ref, target)
        gt_h, gt_w = img_in.shape[:2]
        out = _pack(img_in, img_ref, gt_h, gt_w, scale)
        out['img_in'] = img2tensor(img_in_gt, bgr2rgb=False, float32=True)
        out['lq_path'] = ref_path
        out['padding'] = padding
        out['original_size'] = (in_h, in_w)
        return out

    def __len__(self):
        return len(self.samples)


@DATASET_REGISTRY.register()
class RefMegaDepthCVTDataset(RefMegaDepthDataset):
    """The CVT variant: training samples add a homography-warped ref and
    its degradations, ``img_ref_hrp``, ``img_ref_hrp_lq`` and
    ``img_ref_hrp_up`` (reference ref_megadepth_dataset.py:247-367)."""

    def __getitem__(self, index):
        if self.opt['phase'] != 'train':
            return super().__getitem__(index)
        scale = self.opt['scale']
        img_in, img_ref, pt_a, pt_b, _ = self._load_pair(index)
        img_in, img_ref = self._train_crop(img_in, img_ref, pt_a, pt_b)
        gt = self.opt['gt_size']
        img_ref_hrp, _, _ = image_pair_generation_perspective(
            (img_ref * 255).astype(np.uint8), self.np_rng,
            random_perturb_range=(5, 20), dsize=(gt, gt))
        img_ref_hrp = img_ref_hrp.astype(np.float32) / 255.
        out = _pack(img_in, img_ref, gt, gt, scale)
        hrp_lq, hrp_up = _rgb_lq_up(img_ref_hrp, gt // scale, gt // scale,
                                    gt, gt)
        out['img_ref_hrp'], out['img_ref_hrp_lq'], out['img_ref_hrp_up'] = \
            img2tensor([img_ref_hrp, hrp_lq, hrp_up], bgr2rgb=False,
                       float32=True)
        return out


@DATASET_REGISTRY.register()
class SingleRefMegaDepthDataset:
    """The 5-ref LMR CSV with one ref per sample, drawn at random
    (reference basicsr/data/single_ref_dataset.py:20-123): the target and
    that ref cropped to ``gt_size`` around their match points and
    flipped."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.in_folder = opt['dataroot_in']
        self.ref_folder = opt['dataroot_ref']
        self.ann_file = opt['ann_file']
        self.samples = []
        for (target, h, m1, m2, l1, l2, p0, p1, p2, p3, p4, p5,
             scene) in _rows(self.ann_file):
            self.samples.append((
                osp.join(self.in_folder, scene, target),
                [osp.join(self.in_folder, scene, name)
                 for name in (h, m1, m2, l1, l2)],
                np.array(literal_eval(p0)),
                [np.array(literal_eval(p)) for p in (p1, p2, p3, p4, p5)]))

    def __getitem__(self, index):
        in_path, ref_paths, p0, p_refs = self.samples[index]
        pick = self.np_rng.permutation(5)[0]
        img_in, img_ref = _read_rgb(in_path), _read_rgb(ref_paths[pick])
        gt = self.opt['gt_size']
        img_in = match_point_crop(img_in, p0, gt, gt)
        img_ref = match_point_crop(img_ref, p_refs[pick], gt, gt)
        img_in, img_ref = augment([img_in, img_ref], self.opt['use_flip'],
                                  self.opt['use_rot'], rng=self.rng)
        return _pack(img_in, img_ref, gt, gt, self.opt['scale'])

    def __len__(self):
        return len(self.samples)
