"""FID of the images of a folder against dataset statistics (port of
``scripts/metrics/calculate_fid_folder.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.metrics.calculate_fid_folder \\
        <folder> --fid_stats inception_FFHQ_256.pth \\
        [--inception_path pt_inception.pth] [--device cpu]

The images are read as ``SingleImageDataset`` reads them (``--backend``
disk, lmdb or pack), mapped to [-1, 1], and go through the FID Inception
on the card unless ``--device`` names another; ``--inception_path`` names
converted ``pt_inception`` weights (seeded stand-ins without it). Prints
``fid:`` and returns it.
"""
import argparse
import math

import numpy as np

from mrefsr_tpu_torch.data import build_dataset
from mrefsr_tpu_torch.metrics.fid import (calculate_fid,
                                          extract_inception_features,
                                          load_fid_stats,
                                          load_patched_inception_v3)


def batches(dataset, key, num_sample, batch_size):
    """The first ``num_sample`` samples' ``key`` arrays, stacked into
    batches of ``batch_size`` (the last one short)."""
    num_sample = min(num_sample, len(dataset))
    for i in range(0, num_sample, batch_size):
        yield np.stack([dataset[j][key] for j in
                        range(i, min(i + batch_size, num_sample))], axis=0)


def fid_of_features(features, fid_stats):
    """The FID of ``features`` against the statistics file ``fid_stats``."""
    real_mu, real_cov = load_fid_stats(fid_stats)
    return calculate_fid(np.mean(features, 0),
                         np.cov(features, rowvar=False), real_mu, real_cov)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('folder', type=str, help='Path to the folder.')
    parser.add_argument('--fid_stats', type=str, required=True,
                        help='Path to the dataset fid statistics (.pth)')
    parser.add_argument('--inception_path', type=str, default=None,
                        help='Converted pt_inception weights (.pth)')
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--num_sample', type=int, default=50000)
    parser.add_argument('--num_workers', type=int, default=4,
                        help='read, as the reference, and unused')
    parser.add_argument('--backend', type=str, default='disk')
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    args = parser.parse_args(argv)

    inception = load_patched_inception_v3(args.inception_path,
                                          device=args.device)
    dataset = build_dataset({
        'name': 'SingleImageDataset', 'type': 'SingleImageDataset',
        'phase': 'val', 'dataroot_lq': args.folder,
        'io_backend': {'type': args.backend},
        'mean': [0.5, 0.5, 0.5], 'std': [0.5, 0.5, 0.5]})
    num_sample = min(args.num_sample, len(dataset))
    features = extract_inception_features(
        batches(dataset, 'lq', num_sample, args.batch_size), inception,
        math.ceil(num_sample / args.batch_size))
    fid = fid_of_features(features[:num_sample], args.fid_stats)
    print('fid:', fid)
    return fid


if __name__ == '__main__':
    main()
