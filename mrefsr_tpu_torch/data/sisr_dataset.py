"""Plain single-image views of the multi-ref sets (port of
``mrefsr_tpu/data/sisr_dataset.py``, the reference's
basicsr/data/sisr_dataset.py): HR images and their Pillow-bicubic LR, for
MegaDepth and CUFED, and the Sun80, Manga109, WR-SR and MegaDepth test
sets. Samples are HWC RGB float32 in [0, 1], as the JAX package's.

Each LR image is Pillow's uint8 bicubic of the HR one: a float image is
first truncated to uint8 (``(img * 255).astype(uint8)``), as the
reference's call sites do. The random flips draw from the dataset's own
``random.Random(seed)``, in the JAX package's order."""
import csv
import glob
import os.path as osp
import random
from ast import literal_eval

import numpy as np

from mrefsr_tpu_torch.utils import img2tensor
from mrefsr_tpu_torch.utils.file_client import ensure_file_client
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_util import (match_point_crop, paired_paths_from_ann_file,
                        paired_paths_from_folder, paired_paths_from_lmdb)
from .multi_ref_dataset import _pil_resize
from .transforms import augment, mod_crop


def _pil_bicubic_down(img_rgb01, lq_w, lq_h):
    """Pillow's bicubic downsample of an RGB float image in [0, 1] to
    ``(lq_w, lq_h)``, through uint8 (JAX package sisr_dataset.py:23-29)."""
    return _pil_resize((img_rgb01 * 255).astype(np.uint8),
                       (lq_w, lq_h)).astype(np.float32) / 255.


@DATASET_REGISTRY.register()
class SISRMegaDepthDataset:
    """MegaDepth-LMR's targets alone (reference sisr_dataset.py:22-108):
    ``gt_size`` cropped around the annotated match point, flipped and
    transposed (``use_flip``, ``use_rot``), Pillow-bicubic down by
    ``scale`` for ``lq``. The annotation CSV is the multi-ref set's
    (``MultiRefMegaDepthDataset``)."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.in_folder = opt['dataroot_in']
        self.ref_folder = opt['dataroot_ref']
        self.ann_file = opt['ann_file']
        self.load_annotations()

    def load_annotations(self):
        """``samples``: (target path, target point) per row of the CSV
        (columns target, H, M1, M2, L1, L2, p0 ... p5, scene)."""
        self.samples = []
        with open(self.ann_file, newline='') as f:
            rows = csv.reader(f)
            next(rows)
            for row in rows:
                target, p0, scene = row[0], row[6], row[12]
                self.samples.append((osp.join(self.in_folder, scene, target),
                                     np.array(literal_eval(p0))))

    def __getitem__(self, index):
        from PIL import Image
        scale = self.opt['scale']
        in_path, p0 = self.samples[index]
        img_in = np.array(Image.open(in_path).convert('RGB')).astype(
            np.float32) / 255.
        gt = self.opt['gt_size']
        img_in = match_point_crop(img_in, p0, gt, gt)
        img_in = augment(img_in, self.opt['use_flip'], self.opt['use_rot'],
                         rng=self.rng)
        img_in_lq = _pil_bicubic_down(img_in, gt // scale, gt // scale)
        img_in, img_in_lq = img2tensor([img_in, img_in_lq], bgr2rgb=False)
        return {'gt': img_in, 'lq': img_in_lq}

    def __len__(self):
        return len(self.samples)


@DATASET_REGISTRY.register()
class SISRCUFEDDataset:
    """CUFED's inputs alone (reference sisr_dataset.py:112-236); paths from
    an lmdb pair, an ``ann_file`` or two folders. A training sample is
    flipped and transposed, any other cropped to a multiple of ``scale``;
    ``lq`` is its Pillow bicubic down by ``scale``.

    As the reference and the JAX package, a sample of ``phase: train`` is
    an empty dict: upstream this set only evaluates (ROADMAP C,
    "Found in the JAX package")."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.file_client = None
        self.io_backend_opt = dict(opt['io_backend'])
        self.in_folder = opt['dataroot_in']
        self.ref_folder = opt['dataroot_ref']
        self.filename_tmpl = opt.get('filename_tmpl', '{}')
        folders, keys = [self.in_folder, self.ref_folder], ['in', 'ref']
        if self.io_backend_opt['type'] == 'lmdb':
            self.io_backend_opt['db_paths'] = folders
            self.io_backend_opt['client_keys'] = keys
            self.paths = paired_paths_from_lmdb(folders, keys)
        elif 'ann_file' in opt:
            self.paths = paired_paths_from_ann_file(folders, keys,
                                                    opt['ann_file'])
        else:
            self.paths = paired_paths_from_folder(folders, keys,
                                                  self.filename_tmpl)

    def __getitem__(self, index):
        import cv2
        ensure_file_client(self)
        scale = self.opt['scale']
        in_path = self.paths[index]['in_path']
        img_in = cv2.imdecode(
            np.frombuffer(self.file_client.get(in_path, 'in'), np.uint8),
            cv2.IMREAD_COLOR).astype(np.float32) / 255.
        if self.opt['phase'] == 'train':
            # the flips' draws are made, the sample is empty (docstring)
            augment(img_in, self.opt['use_flip'], self.opt['use_rot'],
                    rng=self.rng)
            return {}
        img_in = mod_crop(img_in, scale)
        gt_h, gt_w, _ = img_in.shape
        lq_rgb = _pil_bicubic_down(cv2.cvtColor(img_in, cv2.COLOR_BGR2RGB),
                                   gt_w // scale, gt_h // scale)
        img_in_lq = cv2.cvtColor(lq_rgb, cv2.COLOR_RGB2BGR)
        img_in, img_in_lq = img2tensor([img_in, img_in_lq])
        return {'gt': img_in, 'lq': img_in_lq,
                'lq_path': self.paths[index]['ref_path']}

    def __len__(self):
        return len(self.paths)


class _GlobSISRTestSet:
    """The glob test sets' sample (reference sisr_dataset.py:240-357): the
    OpenCV-read image cropped to a multiple of ``scale``, its Pillow
    bicubic down taken from the BGR array (as the reference does), both
    to RGB."""

    pattern = '*.png'

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.input_list = sorted(glob.glob(osp.join(opt['dataroot_in'],
                                                    self.pattern)))

    def __len__(self):
        return len(self.input_list)

    def __getitem__(self, idx):
        import cv2
        scale = self.opt['scale']
        img_in = mod_crop(cv2.imread(self.input_list[idx]), scale)
        gt_h, gt_w, _ = img_in.shape
        img_in_lq = _pil_resize(img_in, (gt_w // scale, gt_h // scale))
        img_in, img_in_lq = img2tensor(
            [img_in.astype(np.float32) / 255.,
             img_in_lq.astype(np.float32) / 255.])
        return {'gt': img_in, 'lq': img_in_lq,
                'lq_path': osp.basename(self.input_list[idx])}


@DATASET_REGISTRY.register()
class SISRSun80Set(_GlobSISRTestSet):
    """Sun80's HR images, ``Sun_Hays_SR_groundtruth/*.jpg`` (reference
    sisr_dataset.py:240-277)."""

    pattern = 'Sun_Hays_SR_groundtruth/*.jpg'


@DATASET_REGISTRY.register()
class SISRManga109Set(_GlobSISRTestSet):
    """Manga109's ``*.png`` (reference sisr_dataset.py:280-317)."""


@DATASET_REGISTRY.register()
class SISRWRSRSet(_GlobSISRTestSet):
    """WR-SR's ``*.png`` (reference sisr_dataset.py:320-357)."""


@DATASET_REGISTRY.register()
class SISRMegaDepthTestSet(_GlobSISRTestSet):
    """The images ``test1600Pairs.csv``'s first column names under
    ``test1600Pairs/`` (reference sisr_dataset.py:360-399)."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        folder = osp.join(opt['dataroot_in'], 'test1600Pairs')
        with open(osp.join(opt['dataroot_in'], 'test1600Pairs.csv'),
                  newline='') as f:
            rows = csv.reader(f)
            next(rows)
            self.input_list = [osp.join(folder, row[0]) for row in rows]


@DATASET_REGISTRY.register()
class SISRMegaDepthv3TestSet(_GlobSISRTestSet):
    """One folder a sample under ``data_folder``, named ``xxxxx<name>``,
    holding the HR image ``<name>``; ``lq_path`` is the folder's name
    (reference sisr_dataset.py:402-443)."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.folders = sorted(glob.glob(osp.join(opt['data_folder'], '*')))
        self.input_list = [osp.join(folder, osp.basename(folder)[5:])
                           for folder in self.folders]

    def __getitem__(self, idx):
        item = super().__getitem__(idx)
        item['lq_path'] = osp.basename(self.folders[idx])
        return item
