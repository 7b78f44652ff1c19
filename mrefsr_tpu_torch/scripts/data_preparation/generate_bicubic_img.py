"""Bicubic LR images, and optionally their bicubic upsampling, by MATLAB's
``imresize`` (port of ``scripts/data_preparation/generate_bicubic_img.py``,
itself the reference's ``generate_bicubic_img.m``)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.generate_bicubic_img \\
        --input HR --output_lr LR [--output_bic BIC] [--scale 4]

Each HR image is cropped to a multiple of the scale, resized by
``1 / scale`` with antialiasing (the port's ``utils/matlab_functions.py``,
on the host) and written as 8-bit levels; ``--output_bic`` also takes the
LR image back up by ``scale``.
"""
import argparse
import os
import os.path as osp

import numpy as np

from mrefsr_tpu_torch.utils.matlab_functions import imresize
from mrefsr_tpu_torch.utils.misc import scandir


def to_uint8(img):
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def main(argv=None):
    import cv2
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input', type=str, required=True,
                        help='HR image folder')
    parser.add_argument('--output_lr', type=str, required=True)
    parser.add_argument('--output_bic', type=str, default=None,
                        help='optional bicubic-upsampled output folder')
    parser.add_argument('--scale', type=int, default=4)
    args = parser.parse_args(argv)

    os.makedirs(args.output_lr, exist_ok=True)
    if args.output_bic:
        os.makedirs(args.output_bic, exist_ok=True)

    for path in sorted(scandir(args.input, full_path=True)):
        name = osp.basename(path)
        img = cv2.imread(path).astype(np.float64) / 255.
        h, w = img.shape[:2]
        img = img[:h - h % args.scale, :w - w % args.scale]
        lr = imresize(img, scale=1 / args.scale, antialiasing=True)
        cv2.imwrite(osp.join(args.output_lr, name), to_uint8(lr))
        if args.output_bic:
            bic = imresize(lr, scale=args.scale, antialiasing=True)
            cv2.imwrite(osp.join(args.output_bic, name), to_uint8(bic))
        print('Processed', name)


if __name__ == '__main__':
    main()
