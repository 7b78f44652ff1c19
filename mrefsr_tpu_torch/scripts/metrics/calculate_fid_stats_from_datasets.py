"""FID statistics (the Inception features' mean and covariance) of an FFHQ
folder (port of ``scripts/metrics/calculate_fid_stats_from_datasets.py``,
the reference's)::

    python -m mrefsr_tpu_torch.scripts.metrics.\\
calculate_fid_stats_from_datasets --dataroot datasets/ffhq --size 256 \\
        [--num_sample 50000] [--inception_path pt_inception.pth] \\
        [--save inception_ffhq_256.pth] [--device cpu]

The images are read as ``FFHQDataset`` reads them, mapped to [-1, 1],
and go through the FID Inception on the card unless ``--device`` names
another. Writes ``{'name', 'size', 'mean', 'cov'}`` (numpy arrays, as the
reference's files hold them) to ``--save`` (``inception_ffhq_<size>.pth``
by default) and returns the mean and covariance.
"""
import argparse
import math

import numpy as np
import torch

from mrefsr_tpu_torch.data import build_dataset
from mrefsr_tpu_torch.metrics.fid import (extract_inception_features,
                                          load_patched_inception_v3)
from mrefsr_tpu_torch.scripts.metrics.calculate_fid_folder import batches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--num_sample', type=int, default=50000)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--size', type=int, default=512)
    parser.add_argument('--dataroot', type=str, default='datasets/ffhq')
    parser.add_argument('--inception_path', type=str, default=None)
    parser.add_argument('--save', type=str, default=None,
                        help='default inception_ffhq_<size>.pth')
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    args = parser.parse_args(argv)

    dataset = build_dataset({
        'name': 'FFHQ', 'type': 'FFHQDataset', 'phase': 'train',
        'dataroot_gt': args.dataroot, 'io_backend': {'type': 'disk'},
        'use_hflip': False, 'mean': [0.5, 0.5, 0.5],
        'std': [0.5, 0.5, 0.5]})
    inception = load_patched_inception_v3(args.inception_path,
                                          device=args.device)
    features = extract_inception_features(
        batches(dataset, 'gt', args.num_sample, args.batch_size), inception,
        math.ceil(args.num_sample / args.batch_size))
    features = features[:args.num_sample]
    print(f'Extracted {features.shape[0]} features.')
    mean, cov = np.mean(features, 0), np.cov(features, rowvar=False)
    torch.save({'name': 'ffhq', 'size': args.size, 'mean': mean, 'cov': cov},
               args.save or f'inception_ffhq_{args.size}.pth')
    return mean, cov


if __name__ == '__main__':
    main()
