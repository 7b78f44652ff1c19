"""Tensors to images on the host, and image files (the port's copy of what
``mrefsr_tpu/utils/img_util.py`` and ``mrefsr_tpu/data/data_util.py`` do
for sample grids and video frames). ``cv2`` is imported inside
:func:`imwrite` and :func:`read_img_seq` only: nothing else here needs it."""
import math
import os
import os.path as osp

import numpy as np
import torch


def _make_grid(batch, nrow, padding=2):
    """(N, H, W, C) -> one (rows, cols, C) image of ``nrow`` images a row
    with ``padding`` zero pixels between them."""
    n, h, w, c = batch.shape
    rows = math.ceil(n / nrow)
    grid = batch.new_zeros((h * rows + padding * (rows - 1),
                            w * nrow + padding * (nrow - 1), c))
    for idx in range(n):
        r, col = divmod(idx, nrow)
        grid[r * (h + padding):r * (h + padding) + h,
             col * (w + padding):col * (w + padding) + w] = batch[idx]
    return grid


def tensor2img(tensor, rgb2bgr=True, out_type=np.uint8, min_max=(0, 1)):
    """Tensor(s) -> uint8 BGR HWC numpy image(s).

    Takes NHWC (a batch of 1 is squeezed, a larger one tiled into a grid
    of ``int(sqrt(N))`` images a row), HWC or HW, channel order RGB, as a
    torch tensor on any device or a numpy array. Clamps to ``min_max``,
    rescales to [0, 1], rounds half to even to uint8: the same contract
    as the JAX package's ``tensor2img``. The arithmetic runs where the
    tensor lies; only the finished image crosses to the host."""
    single_input = not isinstance(tensor, list)
    if single_input:
        tensor = [tensor]
    result = []
    for t in tensor:
        arr = torch.as_tensor(t).detach().to(torch.float32)
        if arr.dim() == 4:
            if arr.shape[0] == 1:
                arr = arr[0]
            else:
                arr = _make_grid(arr, nrow=int(math.sqrt(arr.shape[0])))
        arr = (arr.clamp(min_max[0], min_max[1]) - min_max[0]) \
            / (min_max[1] - min_max[0])
        if arr.dim() == 3:
            if arr.shape[2] == 1:  # gray
                arr = arr[:, :, 0]
            elif rgb2bgr:
                arr = arr.flip(2)
        elif arr.dim() != 2:
            raise TypeError('Only support 4D, 3D or 2D arrays. '
                            f'Got dimension: {arr.dim()}')
        if out_type == np.uint8:
            arr = (arr * 255.0).round().to(torch.uint8)
        result.append(arr.cpu().numpy().astype(out_type, copy=False))
    return result[0] if single_input else result


def tensor2img_fast(tensor, rgb2bgr=True, min_max=(0, 1)):
    """One (1, h, w, c) or (h, w, c) image (tensor or array) as uint8:
    clipped to ``min_max``, scaled to [0, 255] and truncated, as the
    reference's ``.type(torch.uint8)`` (reference img_util.py:97-111)."""
    if torch.is_tensor(tensor):
        tensor = tensor.detach().float().cpu().numpy()
    arr = np.asarray(tensor, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(arr, min_max[0], min_max[1])
    arr = ((arr - min_max[0]) / (min_max[1] - min_max[0]) * 255).astype(
        np.uint8)
    return np.ascontiguousarray(arr[:, :, ::-1]) if rgb2bgr else arr


def crop_border(imgs, crop_border):
    """HWC image(s) without ``crop_border`` pixels at each edge (reference
    img_util.py:156-172)."""
    if crop_border == 0:
        return imgs
    if isinstance(imgs, list):
        return [v[crop_border:-crop_border, crop_border:-crop_border, ...]
                for v in imgs]
    return imgs[crop_border:-crop_border, crop_border:-crop_border, ...]


def imwrite(img, file_path, params=None, auto_mkdir=True):
    """Write a BGR HWC image (reference img_util.py:135-153)."""
    import cv2
    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)),
                    exist_ok=True)
    if not cv2.imwrite(file_path, img, params):
        raise IOError('Failed in writing images.')


def imfrombytes(content, flag='color', float32=False):
    """An image decoded from bytes with OpenCV: HWC BGR uint8, or float32
    in [0, 1] with ``float32`` (reference img_util.py:114-133)."""
    import cv2
    flags = {'color': cv2.IMREAD_COLOR, 'grayscale': cv2.IMREAD_GRAYSCALE,
             'unchanged': cv2.IMREAD_UNCHANGED}
    img = cv2.imdecode(np.frombuffer(content, np.uint8), flags[flag])
    if img is None:
        raise IOError('cannot decode an image from the bytes given')
    if float32:
        img = img.astype(np.float32) / 255.
    return img


def img2tensor(imgs, bgr2rgb=True, float32=True):
    """Numpy HWC image(s) -> contiguous HWC RGB numpy array(s), float32
    unless ``float32`` is false (the JAX package's contract: the arrays
    batch NHWC)."""

    def _one(img):
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 3 and bgr2rgb:
            img = img[:, :, ::-1]
        if float32:
            img = img.astype(np.float32)
        return np.ascontiguousarray(img)

    return [_one(img) for img in imgs] if isinstance(imgs, list) \
        else _one(imgs)


def read_img_seq(path, require_mod_crop=False, scale=1,
                 return_imgname=False):
    """Read the frames of a folder (sorted by name) or of a list of paths
    into one ``(T, H, W, 3)`` float32 RGB array in [0, 1] (reference
    data_util.py:11-40); with ``require_mod_crop`` each frame is cropped to
    a multiple of ``scale``; with ``return_imgname`` also the file names
    without extension."""
    import cv2
    if isinstance(path, list):
        img_paths = path
    else:
        img_paths = sorted(osp.join(path, name) for name in os.listdir(path)
                           if not name.startswith('.')
                           and osp.isfile(osp.join(path, name)))
    imgs = []
    for p in img_paths:
        img = cv2.imread(p)
        if img is None:
            raise IOError(f'cannot read an image from {p}')
        img = img.astype(np.float32) / 255.
        if require_mod_crop:
            h, w = img.shape[:2]
            img = img[:h - h % scale, :w - w % scale]
        imgs.append(img)
    imgs = np.stack(img2tensor(imgs), axis=0)
    if return_imgname:
        return imgs, [osp.splitext(osp.basename(p))[0] for p in img_paths]
    return imgs
