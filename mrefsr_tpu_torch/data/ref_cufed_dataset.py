"""Single-reference CUFED datasets (port of
``mrefsr_tpu/data/ref_cufed_dataset.py:76-204``, the reference's
``basicsr/data/ref_cufed_dataset.py``): HWC RGB float32 samples in [0, 1]
with the reference's Pillow bicubic down-and-up chain.

The random draws come from the dataset's own ``random.Random(seed)``
(the flips) and ``np.random.RandomState(seed)`` (the CVT homography), in
the order of the JAX package's draws from python's and numpy's global
generators, so one seed gives both packages the same samples. Images are
read through the file client (``io_backend``: ``disk``, or ``lmdb`` with
the two folders as its databases, keys ``in`` and ``ref``)."""
import random

import numpy as np

from mrefsr_tpu_torch.utils import img2tensor
from mrefsr_tpu_torch.utils.file_client import ensure_file_client
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_util import (paired_paths_from_ann_file, paired_paths_from_folder,
                        paired_paths_from_lmdb)
from .multi_ref_dataset import _impad_to
from .transforms import augment, mod_crop


def _bgr_to_pil(img01):
    import cv2
    from PIL import Image
    return Image.fromarray(
        cv2.cvtColor((img01 * 255).astype(np.uint8), cv2.COLOR_BGR2RGB))


def _pil_to_bgr(pil):
    import cv2
    return cv2.cvtColor(np.array(pil),
                        cv2.COLOR_RGB2BGR).astype(np.float32) / 255.


def _lq_up_chain(img_bgr01, lq_w, lq_h, gt_w, gt_h):
    """Pillow's bicubic down and back up (reference
    ref_cufed_dataset.py:136-162): ``(lq, up)``, BGR in [0, 1]."""
    from PIL import Image
    lq = _bgr_to_pil(img_bgr01).resize((lq_w, lq_h), Image.BICUBIC)
    up = lq.resize((gt_w, gt_h), Image.BICUBIC)
    return _pil_to_bgr(lq), _pil_to_bgr(up)


def image_pair_generation_perspective(img, np_rng,
                                      random_perturb_range=(0, 32),
                                      cropping_window_size=160, dsize=None):
    """A random homography warp of ``img`` (reference
    ref_cufed_dataset.py:190-273): the four corners of a crop window
    perturbed by draws from ``np_rng``, the image warped by the inverse
    homography. Returns ``(warped, homography, inverse)``, or the inverse
    alone for ``img`` None."""
    import cv2
    h, w = img.shape[:2] if img is not None else (160, 160)
    crop = cropping_window_size
    x_tl = np_rng.randint(random_perturb_range[1],
                          max(w, w - crop - random_perturb_range[1]))
    y_tl = np_rng.randint(random_perturb_range[1],
                          max(h, h - crop - random_perturb_range[1]))
    rect1 = np.array([(x_tl, y_tl), (x_tl + crop, y_tl),
                      (x_tl + crop, y_tl + crop), (x_tl, y_tl + crop)],
                     dtype=np.float32)

    def perturb(v):
        return v + np_rng.randint(*random_perturb_range) * \
            np_rng.choice([-1.0, 1.0])

    rect2 = np.array([(perturb(x), perturb(y)) for x, y in rect1],
                     dtype=np.float32)
    homography = cv2.getPerspectiveTransform(src=rect1, dst=rect2)
    h_inverse = np.linalg.inv(homography)
    if img is None:
        return h_inverse
    warped = cv2.warpPerspective(src=img, M=h_inverse,
                                 dsize=dsize or (w, h),
                                 flags=cv2.INTER_CUBIC)
    return warped, homography, h_inverse


@DATASET_REGISTRY.register()
class RefCUFEDDataset:
    """Single-ref CUFED pairs (reference ref_cufed_dataset.py:16-187):
    ``dataroot_in`` / ``dataroot_ref`` folders paired by name
    (``filename_tmpl``) or by ``ann_file``. Training resizes the ref to
    ``gt_size`` and flips both; testing mod-crops both and zero-pads them to
    a common size (``padding``, ``original_size``). Samples hold
    ``img_in``, ``img_in_lq``, ``img_in_up``, ``img_ref``, ``img_ref_lq``,
    ``img_ref_up``. With ``io_backend: lmdb`` the pairs are the keys both
    databases' ``meta_info.txt`` list (JAX package
    ref_cufed_dataset.py:89-112)."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
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

    def _load_pair(self, index):
        import cv2
        client = ensure_file_client(self)

        def read(path, key):
            data = np.frombuffer(client.get(path, key), np.uint8)
            return cv2.imdecode(data, cv2.IMREAD_COLOR).astype(
                np.float32) / 255.

        ref_path = self.paths[index]['ref_path']
        return (read(self.paths[index]['in_path'], 'in'),
                read(ref_path, 'ref'), ref_path)

    def _train_pair(self, img_in, img_ref):
        """The ref resized to ``gt_size`` (Pillow), then one flip draw for
        both (reference :95-105)."""
        from PIL import Image
        gt_h = gt_w = self.opt['gt_size']
        img_ref = _pil_to_bgr(
            _bgr_to_pil(img_ref).resize((gt_w, gt_h), Image.BICUBIC))
        img_in, img_ref = augment([img_in, img_ref], self.opt['use_flip'],
                                  self.opt['use_rot'], rng=self.rng)
        return img_in, img_ref, gt_h, gt_w

    @staticmethod
    def _test_pair(img_in, img_ref, scale):
        """Mod-crop both and zero-pad them to a common size (reference
        :107-125)."""
        img_in = mod_crop(img_in, scale)
        img_in_gt = img_in.copy()
        img_ref = mod_crop(img_ref, scale)
        (in_h, in_w), (ref_h, ref_w) = img_in.shape[:2], img_ref.shape[:2]
        padding = (in_h, in_w) != (ref_h, ref_w)
        if padding:
            target = (max(in_h, ref_h), max(in_w, ref_w))
            img_in = _impad_to(img_in, target)
            img_ref = _impad_to(img_ref, target)
        return img_in, img_in_gt, img_ref, padding, (in_h, in_w)

    def _pack(self, img_in, img_ref, gt_h, gt_w, scale):
        lq_h, lq_w = gt_h // scale, gt_w // scale
        img_in_lq, img_in_up = _lq_up_chain(img_in, lq_w, lq_h, gt_w, gt_h)
        img_ref_lq, img_ref_up = _lq_up_chain(img_ref, lq_w, lq_h, gt_w,
                                              gt_h)
        keys = ('img_in', 'img_in_lq', 'img_in_up', 'img_ref',
                'img_ref_lq', 'img_ref_up')
        return dict(zip(keys, img2tensor(
            [img_in, img_in_lq, img_in_up, img_ref, img_ref_lq, img_ref_up],
            bgr2rgb=True, float32=True)))

    def __getitem__(self, index):
        scale = self.opt['scale']
        img_in, img_ref, ref_path = self._load_pair(index)
        if self.opt['phase'] == 'train':
            img_in, img_ref, gt_h, gt_w = self._train_pair(img_in, img_ref)
            return self._pack(img_in, img_ref, gt_h, gt_w, scale)
        img_in, img_in_gt, img_ref, padding, original_size = \
            self._test_pair(img_in, img_ref, scale)
        gt_h, gt_w = img_in.shape[:2]
        out = self._pack(img_in, img_ref, gt_h, gt_w, scale)
        out['img_in'] = img2tensor(img_in_gt, bgr2rgb=True, float32=True)
        out['lq_path'] = ref_path
        out['padding'] = padding
        out['original_size'] = original_size
        return out

    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class RefCUFEDCVTDataset(RefCUFEDDataset):
    """The CVT variant: training samples add a homography-warped ref
    (160 x 160) and its degradations, ``img_ref_hrp``, ``img_ref_hrp_lq``
    and ``img_ref_hrp_up`` (reference ref_cufed_dataset.py:276-412)."""

    def __getitem__(self, index):
        if self.opt['phase'] != 'train':
            return super().__getitem__(index)
        scale = self.opt['scale']
        img_in, img_ref, _ = self._load_pair(index)
        img_in, img_ref, gt_h, gt_w = self._train_pair(img_in, img_ref)
        img_ref_hrp, _, _ = image_pair_generation_perspective(
            (img_ref * 255).astype(np.uint8), self.np_rng,
            random_perturb_range=(5, 20), dsize=(160, 160))
        img_ref_hrp = img_ref_hrp.astype(np.float32) / 255.
        out = self._pack(img_in, img_ref, gt_h, gt_w, scale)
        lq_h, lq_w = gt_h // scale, gt_w // scale
        hrp_lq, hrp_up = _lq_up_chain(img_ref_hrp, lq_w, lq_h, gt_w, gt_h)
        out['img_ref_hrp'], out['img_ref_hrp_lq'], out['img_ref_hrp_up'] = \
            img2tensor([img_ref_hrp, hrp_lq, hrp_up], bgr2rgb=True,
                       float32=True)
        return out
