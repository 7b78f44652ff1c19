"""PSNR and SSIM over two folders of images (port of
``scripts/metrics/calculate_psnr_ssim.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.metrics.calculate_psnr_ssim \\
        --gt datasets/val_set14/Set14 --restored results/Set14 \\
        [--crop_border 4] [--suffix _x4] [--test_y_channel]

The images pair by sorted order, or by name plus ``--suffix``; numpy on
the host. Prints each image's values and the averages, and returns the
averages.
"""
import argparse
import os.path as osp

import numpy as np

from mrefsr_tpu_torch.metrics import calculate_psnr, calculate_ssim
from mrefsr_tpu_torch.utils.color_util import bgr2ycbcr
from mrefsr_tpu_torch.utils.misc import scandir


def _read(path):
    import cv2
    return cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 255.


def _correct_mean_var(img_restored, img_gt):
    """``img_restored``'s channels moved to ``img_gt``'s means and standard
    deviations, twice, as the reference does."""
    for j in range(3):
        mean_l, std_l = np.mean(img_gt[:, :, j]), np.std(img_gt[:, :, j])
        for _ in range(2):
            img_restored[:, :, j] += mean_l - np.mean(img_restored[:, :, j])
            img_restored[:, :, j] *= std_l / np.std(img_restored[:, :, j])
    return img_restored


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--gt', type=str, default='datasets/val_set14/Set14')
    parser.add_argument('--restored', type=str, default='results/Set14')
    parser.add_argument('--crop_border', type=int, default=4)
    parser.add_argument('--suffix', type=str, default='')
    parser.add_argument('--test_y_channel', action='store_true')
    parser.add_argument('--correct_mean_var', action='store_true')
    args = parser.parse_args(argv)

    psnr_all, ssim_all = [], []
    img_list_gt = sorted(scandir(args.gt, recursive=True, full_path=True))
    img_list_restored = sorted(scandir(args.restored, recursive=True,
                                       full_path=True))
    print('Testing Y channel.' if args.test_y_channel
          else 'Testing RGB channels.')
    for i, img_path in enumerate(img_list_gt):
        basename, ext = osp.splitext(osp.basename(img_path))
        img_gt = _read(img_path)
        img_restored = _read(
            img_list_restored[i] if args.suffix == '' else
            osp.join(args.restored, basename + args.suffix + ext))
        if args.correct_mean_var:
            img_restored = _correct_mean_var(img_restored, img_gt)
        if args.test_y_channel and img_gt.ndim == 3 \
                and img_gt.shape[2] == 3:
            img_gt = bgr2ycbcr(img_gt, y_only=True)
            img_restored = bgr2ycbcr(img_restored, y_only=True)
        psnr = calculate_psnr(img_gt * 255, img_restored * 255,
                              crop_border=args.crop_border, input_order='HWC')
        ssim = calculate_ssim(img_gt * 255, img_restored * 255,
                              crop_border=args.crop_border, input_order='HWC')
        print(f'{i + 1:3d}: {basename:25}. \tPSNR: {psnr:.6f} dB, '
              f'\tSSIM: {ssim:.6f}')
        psnr_all.append(psnr)
        ssim_all.append(ssim)
    print(args.gt)
    print(args.restored)
    psnr, ssim = sum(psnr_all) / len(psnr_all), sum(ssim_all) / len(ssim_all)
    print(f'Average: PSNR: {psnr:.6f} dB, SSIM: {ssim:.6f}')
    return psnr, ssim


if __name__ == '__main__':
    main()
