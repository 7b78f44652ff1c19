"""HiFaceGAN's degraded training inputs from a folder of faces: 16x mosaic,
Gaussian blur, Gaussian noise or JPEG (port of
``scripts/data_preparation/prepare_hifacegan_dataset.py``)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.prepare_hifacegan_dataset \\
        --input FACES --output DEGRADED [--mode mosaic|blur|noise|jpeg]

The random draws (blur sigma in [2, 5], noise sigma in [10, 50], JPEG
quality in [10, 40]) come from numpy's global generator, as in the JAX
script, so ``np.random.seed`` before a run makes it repeat; the noise and
JPEG go through the port's ``data/degradations.py``.
"""
import argparse
import os
import os.path as osp

import numpy as np

from mrefsr_tpu_torch.data.degradations import (add_jpg_compression,
                                                random_add_gaussian_noise)
from mrefsr_tpu_torch.utils.misc import scandir

MODES = ('mosaic', 'blur', 'noise', 'jpeg')


def mosaic16x(x):
    """Each 16 x 16 block (smaller at the right and bottom edges) replaced
    by its mean (reference :12-23)."""
    h, w = x.shape[:2]
    x = x.astype('float')
    for i in range((h + 15) // 16):
        for j in range((w + 15) // 16):
            block = x[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16]
            x[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16] = block.mean(
                axis=(0, 1))
    return x.astype('uint8')


def degrade(img, mode):
    """``img`` (uint8, HWC) degraded by ``mode``."""
    if mode == 'mosaic':
        return mosaic16x(img)
    if mode == 'blur':
        import cv2
        return cv2.GaussianBlur(img, (0, 0),
                                sigmaX=np.random.uniform(2, 5))
    if mode == 'noise':
        out = random_add_gaussian_noise(img.astype(np.float32) / 255.,
                                        sigma_range=(10, 50),
                                        np_rng=np.random)
        return (out * 255).round().astype(np.uint8)
    if mode == 'jpeg':
        out = add_jpg_compression(img.astype(np.float32) / 255.,
                                  quality=np.random.uniform(10, 40))
        return (out * 255).round().astype(np.uint8)
    raise ValueError(mode)


def main(argv=None):
    import cv2
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--mode', type=str, default='mosaic', choices=MODES)
    args = parser.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    for path in sorted(scandir(args.input, full_path=True)):
        out = degrade(cv2.imread(path), args.mode)
        cv2.imwrite(osp.join(args.output, osp.basename(path)), out)
        print('Processed', osp.basename(path))


if __name__ == '__main__':
    main()
