"""Overlapping sub-images of large DIV2K-style images, for faster training
reads (port of ``scripts/data_preparation/extract_subimages.py``, the
reference's)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.extract_subimages \\
        [--input IN --output OUT --crop_size 480 --step 240] [--n_thread 20]

Without ``--input`` it crops the four DIV2K folders of the reference
(HR at 480 / 240, bicubic X2, X3, X4 at 240 / 120, 160 / 80, 120 / 60).
Each image ``name.ext`` gives ``name_s001.ext``, ``name_s002.ext``, ... in
row-major order of the crop grid; PNGs are written at compression level 3.
An output folder that already exists ends the run with exit code 1, as
the reference does. The images are cropped in a pool of processes
started by ``spawn`` (a fork of a process with threads is unsafe).
"""
import argparse
import os
import os.path as osp
import sys
import multiprocessing

import numpy as np

from mrefsr_tpu_torch.utils.misc import scandir

DIV2K = (
    ('datasets/DIV2K/DIV2K_train_HR',
     'datasets/DIV2K/DIV2K_train_HR_sub', 480, 240),
    ('datasets/DIV2K/DIV2K_train_LR_bicubic/X2',
     'datasets/DIV2K/DIV2K_train_LR_bicubic/X2_sub', 240, 120),
    ('datasets/DIV2K/DIV2K_train_LR_bicubic/X3',
     'datasets/DIV2K/DIV2K_train_LR_bicubic/X3_sub', 160, 80),
    ('datasets/DIV2K/DIV2K_train_LR_bicubic/X4',
     'datasets/DIV2K/DIV2K_train_LR_bicubic/X4_sub', 120, 60),
)


def crop_starts(length, crop_size, step, thresh_size):
    """The crops' first rows (or columns) along ``length``: every ``step``,
    plus one flush with the end where more than ``thresh_size`` would be
    left over (reference :105-110)."""
    space = np.arange(0, length - crop_size + 1, step)
    if length - (space[-1] + crop_size) > thresh_size:
        space = np.append(space, length - crop_size)
    return space


def extract_subimages(opt):
    """Crop every image of ``opt['input_folder']`` into
    ``opt['save_folder']`` with ``opt['n_thread']`` processes."""
    save_folder = opt['save_folder']
    if not osp.exists(save_folder):
        os.makedirs(save_folder)
        print(f'mkdir {save_folder} ...')
    else:
        print(f'Folder {save_folder} already exists. Exit.')
        sys.exit(1)

    img_list = list(scandir(opt['input_folder'], full_path=True))
    pool = multiprocessing.get_context('spawn').Pool(opt['n_thread'])
    jobs = [pool.apply_async(worker, args=(path, opt),
                             callback=lambda p: print(f'Processed {p}'))
            for path in img_list]
    pool.close()
    pool.join()
    for job in jobs:    # a worker's error raises here
        job.get()
    print('All processes done.')


def worker(path, opt):
    """Sliding-window crops of one image (reference :91-141)."""
    import cv2
    crop_size = opt['crop_size']
    img_name, extension = osp.splitext(osp.basename(path))
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)

    h, w = img.shape[0:2]
    h_space = crop_starts(h, crop_size, opt['step'], opt['thresh_size'])
    w_space = crop_starts(w, crop_size, opt['step'], opt['thresh_size'])
    index = 0
    for x in h_space:
        for y in w_space:
            index += 1
            cropped_img = np.ascontiguousarray(
                img[x:x + crop_size, y:y + crop_size, ...])
            cv2.imwrite(
                osp.join(opt['save_folder'],
                         f'{img_name}_s{index:03d}{extension}'),
                cropped_img,
                [cv2.IMWRITE_PNG_COMPRESSION, opt['compression_level']])
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input', type=str, default=None,
                        help='one folder to crop (default: DIV2K)')
    parser.add_argument('--output', type=str, default=None)
    parser.add_argument('--crop_size', type=int, default=480)
    parser.add_argument('--step', type=int, default=240)
    parser.add_argument('--n_thread', type=int, default=20)
    args = parser.parse_args(argv)
    configs = DIV2K if args.input is None else (
        (args.input, args.output, args.crop_size, args.step),)
    opt = {'n_thread': args.n_thread, 'compression_level': 3}
    for input_folder, save_folder, crop_size, step in configs:
        opt.update(input_folder=input_folder, save_folder=save_folder,
                   crop_size=crop_size, step=step, thresh_size=0)
        extract_subimages(opt)


if __name__ == '__main__':
    main()
