"""LPIPS between the images of two folders (port of
``scripts/metrics/calculate_lpips.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.metrics.calculate_lpips \\
        --gt <dir> --restored <dir> --lpips_weights vgg.pth \\
        --vgg16_weights vgg16-397923af.pth [--suffix _x] [--device cpu]

The official LPIPS heads (``vgg.pth``) and torchvision's ``vgg16`` are
local files (nothing is downloaded). The net runs on the card unless
``--device`` names another. Prints each pair's LPIPS and the average, and
returns the average.
"""
import argparse
import os.path as osp

import numpy as np

from mrefsr_tpu_torch.metrics import calculate_lpips
from mrefsr_tpu_torch.utils.misc import scandir


def main(argv=None):
    import cv2
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--gt', type=str,
                        default='datasets/celeba/celeba_512_validation')
    parser.add_argument('--restored', type=str, default='results/restored')
    parser.add_argument('--lpips_weights', type=str, required=True,
                        help='official LPIPS vgg.pth (the lin heads)')
    parser.add_argument('--vgg16_weights', type=str, required=True,
                        help='torchvision vgg16 state dict')
    parser.add_argument('--suffix', type=str, default='',
                        help='suffix of restored filenames')
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    args = parser.parse_args(argv)
    img_list = sorted(scandir(args.gt, recursive=True, full_path=True))
    lpips_all = []
    for i, img_path in enumerate(img_list):
        basename, ext = osp.splitext(osp.basename(img_path))
        img_gt = cv2.imread(img_path, cv2.IMREAD_COLOR)
        img_restored = cv2.imread(
            osp.join(args.restored, basename + args.suffix + ext),
            cv2.IMREAD_COLOR)
        # BGR in, as every metric of the registry takes it
        val = calculate_lpips(img_gt.astype(np.float32),
                              img_restored.astype(np.float32), crop_border=0,
                              lpips_weights=args.lpips_weights,
                              vgg16_weights=args.vgg16_weights,
                              device=args.device)
        print(f'{i + 1:3d}: {basename:25}. \tLPIPS: {val:.6f}.')
        lpips_all.append(val)
    average = sum(lpips_all) / len(lpips_all)
    print(f'Average: LPIPS: {average:.6f}')
    return average


if __name__ == '__main__':
    main()
