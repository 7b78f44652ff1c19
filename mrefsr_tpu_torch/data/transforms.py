"""Host-side image transforms on HWC numpy arrays (port of
``mrefsr_tpu/data/transforms.py:13-158``, the reference's
``basicsr/data/transforms.py:6-158``). ``paired_random_crop`` and
``augment`` draw from the ``random.Random`` their caller passes, where the
JAX package draws from python's global generator: the same seed gives the
same draws. ``img_rotate`` (on no dataset's path) rotates with OpenCV."""
import numpy as np


def mod_crop(img, scale):
    """``img`` cropped to a multiple of ``scale`` in height and width."""
    img = img.copy()
    if img.ndim not in (2, 3):
        raise ValueError(f'Wrong img ndim: {img.ndim}.')
    h, w = img.shape[0], img.shape[1]
    return img[:h - h % scale, :w - w % scale, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale, gt_path=None,
                       *, rng):
    """One random ``gt_patch_size`` window of every gt image and the
    ``gt_patch_size // scale`` window at the same place of every lq image
    (reference transforms.py:26-93): two ``rng.randint`` draws, top then
    left, in lq pixels. A single array in gives a single array out."""
    if not isinstance(img_gts, list):
        img_gts = [img_gts]
    if not isinstance(img_lqs, list):
        img_lqs = [img_lqs]
    h_lq, w_lq = img_lqs[0].shape[0:2]
    h_gt, w_gt = img_gts[0].shape[0:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f'Scale mismatches. GT ({h_gt}, {w_gt}) is not '
                         f'{scale}x multiplication of LQ ({h_lq}, {w_lq}).')
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f'LQ ({h_lq}, {w_lq}) is smaller than patch size '
                         f'({lq_patch_size}, {lq_patch_size}). '
                         f'Please remove {gt_path}.')
    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for v in img_lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    img_gts = [v[top_gt:top_gt + gt_patch_size,
                 left_gt:left_gt + gt_patch_size, ...] for v in img_gts]
    return (img_gts[0] if len(img_gts) == 1 else img_gts,
            img_lqs[0] if len(img_lqs) == 1 else img_lqs)


def augment(imgs, hflip=True, rotation=True, flows=None,
            return_status=False, *, rng):
    """One draw of horizontal flip, vertical flip and transpose (each with
    probability 1/2, the flips only where ``hflip`` / ``rotation`` allow
    them) applied to every image of ``imgs`` and every flow of ``flows``
    (whose vectors turn with them). The draws come from ``rng``, three
    ``rng.random()`` calls at most, in the JAX package's order."""
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _augment(img):
        if hflip:
            img = np.ascontiguousarray(img[:, ::-1, ...])
        if vflip:
            img = np.ascontiguousarray(img[::-1, ...])
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return img

    def _augment_flow(flow):
        if hflip:
            flow = np.ascontiguousarray(flow[:, ::-1, :])
            flow[:, :, 0] *= -1
        if vflip:
            flow = np.ascontiguousarray(flow[::-1, :, :])
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return flow

    if not isinstance(imgs, list):
        imgs = [imgs]
    imgs = [_augment(img) for img in imgs]
    if len(imgs) == 1:
        imgs = imgs[0]
    if flows is not None:
        if not isinstance(flows, list):
            flows = [flows]
        flows = [_augment_flow(flow) for flow in flows]
        if len(flows) == 1:
            flows = flows[0]
        return imgs, flows
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs


def img_rotate(img, angle, center=None, scale=1.0):
    """``img`` turned ``angle`` degrees counter-clockwise about ``center``
    (the middle by default) and scaled, with OpenCV's ``warpAffine``
    (reference transforms.py:161-179)."""
    import cv2
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    matrix = cv2.getRotationMatrix2D(center, angle, scale)
    return cv2.warpAffine(img, matrix, (w, h))
