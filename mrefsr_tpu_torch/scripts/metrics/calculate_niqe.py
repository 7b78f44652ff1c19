"""NIQE of every image of a folder (port of
``scripts/metrics/calculate_niqe.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.metrics.calculate_niqe \\
        --input datasets/val_set14/Set14 [--crop_border 0]

numpy on the host. Prints each image's NIQE and the average, and returns
the average.
"""
import argparse
import os.path as osp
import warnings

from mrefsr_tpu_torch.metrics import calculate_niqe
from mrefsr_tpu_torch.utils.misc import scandir


def main(argv=None):
    import cv2
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input', type=str,
                        default='datasets/val_set14/Set14')
    parser.add_argument('--crop_border', type=int, default=0)
    args = parser.parse_args(argv)
    niqe_all = []
    img_list = sorted(scandir(args.input, recursive=True, full_path=True))
    for i, img_path in enumerate(img_list):
        basename, _ = osp.splitext(osp.basename(img_path))
        img = cv2.imread(img_path, cv2.IMREAD_UNCHANGED)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', category=RuntimeWarning)
            niqe_score = calculate_niqe(img, args.crop_border,
                                        input_order='HWC', convert_to='y')
        print(f'{i + 1:3d}: {basename:25}. \tNIQE: {niqe_score:.6f}')
        niqe_all.append(niqe_score)
    print(args.input)
    average = sum(niqe_all) / len(niqe_all)
    print(f'Average: NIQE: {average:.6f}')
    return average


if __name__ == '__main__':
    main()
