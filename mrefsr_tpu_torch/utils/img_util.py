"""Tensors to images on the host, and image files (the port's copy of what
``mrefsr_tpu/utils/img_util.py`` does for sample grids). ``cv2`` is
imported inside :func:`imwrite` only: nothing else here needs it."""
import math
import os

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


def imwrite(img, file_path, params=None, auto_mkdir=True):
    """Write a BGR HWC image (reference img_util.py:135-153)."""
    import cv2
    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)),
                    exist_ok=True)
    if not cv2.imwrite(file_path, img, params):
        raise IOError('Failed in writing images.')
