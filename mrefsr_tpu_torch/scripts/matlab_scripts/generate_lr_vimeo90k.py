"""Vimeo-90K's bicubic LR frames by MATLAB's ``imresize`` (port of
``scripts/matlab_scripts/generate_lr_vimeo90k.py``, itself the reference's
``generate_LR_Vimeo90K.m``)::

    python -m mrefsr_tpu_torch.scripts.matlab_scripts.generate_lr_vimeo90k \\
        --root datasets/vimeo90k/vimeo_septuplet [--scale 4]

Walks ``<root>/sequences/*/*/*.png``, crops each frame to a multiple of
the scale, resizes it by ``1 / scale`` with antialiasing on the host and
writes the same tree under ``<root>_matlabLRx<scale>``.
"""
import argparse
import glob
import os
import os.path as osp

import numpy as np

from mrefsr_tpu_torch.utils.matlab_functions import imresize


def modcrop(img, modulo):
    h, w = img.shape[:2]
    return img[:h - h % modulo, :w - w % modulo, ...]


def main(argv=None):
    import cv2
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root', type=str, required=True,
                        help='vimeo_septuplet root (contains sequences/)')
    parser.add_argument('--scale', type=int, default=4)
    args = parser.parse_args(argv)

    root = args.root.rstrip('/')
    paths = sorted(glob.glob(osp.join(root, 'sequences', '*', '*', '*.png')))
    out_root = f'{root}_matlabLRx{args.scale}'
    for idx, path in enumerate(paths, 1):
        save_path = out_root + path[len(root):]
        os.makedirs(osp.dirname(save_path), exist_ok=True)
        img = cv2.imread(path, cv2.IMREAD_COLOR).astype(np.float64) / 255.
        lr = imresize(modcrop(img, args.scale), 1 / args.scale)
        lr = np.clip(np.round(lr * 255.), 0, 255).astype(np.uint8)
        cv2.imwrite(save_path, lr)
        print(f'{idx}\t{osp.splitext(osp.basename(path))[0]}.')
    return len(paths)


if __name__ == '__main__':
    main()
