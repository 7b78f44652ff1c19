"""Host-side image transforms on HWC numpy arrays (port of
``mrefsr_tpu/data/transforms.py:13,63``, the reference's
``basicsr/data/transforms.py:6-158``). ``augment`` draws from the
``random.Random`` its caller passes, where the JAX package draws from
python's global generator: the same seed gives the same draws.
``paired_random_crop`` and ``img_rotate`` come with the paired datasets
(ROADMAP A6)."""
import numpy as np


def mod_crop(img, scale):
    """``img`` cropped to a multiple of ``scale`` in height and width."""
    img = img.copy()
    if img.ndim not in (2, 3):
        raise ValueError(f'Wrong img ndim: {img.ndim}.')
    h, w = img.shape[0], img.shape[1]
    return img[:h - h % scale, :w - w % scale, ...]


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
