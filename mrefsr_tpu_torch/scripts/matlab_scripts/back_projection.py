"""Iterative back-projection of SR results onto their LR inputs (port of
``scripts/matlab_scripts/back_projection.py``, itself the reference's
``backprojection.m``, ``main_bp.m`` and ``main_reverse_filter.m``)::

    python -m mrefsr_tpu_torch.scripts.matlab_scripts.back_projection \\
        --sr SR --lr LR --output OUT [--iters 20] [--mode bp|reverse]

An SR image ``name`` (or ``name_<suffix>``) pairs with the LR image
``name``; one without a match is skipped. MATLAB's bicubic ``imresize``
with antialiasing, on the host.
"""
import argparse
import os
import os.path as osp

import numpy as np

from mrefsr_tpu_torch.utils.matlab_functions import imresize
from mrefsr_tpu_torch.utils.misc import scandir


def backprojection(sr, lr, iters=20):
    """``sr <- sr + up(lr - down(sr))``, ``iters`` times
    (backprojection.m)."""
    scale = sr.shape[0] / lr.shape[0]
    for _ in range(iters):
        err = lr - imresize(sr, scale=1 / scale, antialiasing=True)
        sr = sr + imresize(err, scale=scale, antialiasing=True)
    return sr


def reverse_filter(sr, lr, iters=20):
    """``x <- x + (sr - up(down(x)))``, ``iters`` times from ``x = sr``
    (main_reverse_filter.m)."""
    scale = sr.shape[0] / lr.shape[0]
    x = sr.copy()
    for _ in range(iters):
        down = imresize(x, scale=1 / scale, antialiasing=True)
        x = x + (sr - imresize(down, scale=scale, antialiasing=True))
    return x


def main(argv=None):
    import cv2
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--sr', type=str, required=True,
                        help='SR results folder')
    parser.add_argument('--lr', type=str, required=True,
                        help='LR inputs folder')
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--mode', type=str, default='bp',
                        choices=['bp', 'reverse'])
    args = parser.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)

    lr_files = {osp.splitext(osp.basename(p))[0]: p
                for p in scandir(args.lr, full_path=True)}
    fn = backprojection if args.mode == 'bp' else reverse_filter
    for sr_path in sorted(scandir(args.sr, full_path=True)):
        name = osp.splitext(osp.basename(sr_path))[0]
        lr_path = lr_files.get(name) or lr_files.get(name.split('_')[0])
        if lr_path is None:
            print('no LR match for', name, '- skipped')
            continue
        sr = cv2.imread(sr_path).astype(np.float64) / 255.
        lr = cv2.imread(lr_path).astype(np.float64) / 255.
        out = fn(sr, lr, args.iters)
        cv2.imwrite(osp.join(args.output, osp.basename(sr_path)),
                    (np.clip(out, 0, 1) * 255).round().astype(np.uint8))
        print('Processed', name)


if __name__ == '__main__':
    main()
