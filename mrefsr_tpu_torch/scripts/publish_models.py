"""Stamp released checkpoints with the first 8 hex digits of their sha256
(port of ``scripts/publish_models.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.publish_models [paths ...]

``name.pth`` becomes ``name-<sha>.pth``; ``name-<old>.pth`` becomes
``name-<sha>.pth`` where the digits changed (the name is split at its
first ``-``). Without paths it stamps
``experiments/pretrained_models/*.pth`` and the ``.pth`` files one folder
down. A checkpoint without ``params`` or ``params_ema`` asks before it is
stamped.
"""
import argparse
import glob
import hashlib
import os
from os import path as osp

import torch


def sha256_prefix(path, digits=8):
    """The first ``digits`` hex digits of the file's sha256 (what
    ``sha256sum`` prints)."""
    sha = hashlib.sha256()
    with open(path, 'rb') as f:
        for block in iter(lambda: f.read(1 << 20), b''):
            sha.update(block)
    return sha.hexdigest()[:digits]


def update_sha(paths):
    """Rename each of ``paths`` with its sha256 prefix; returns the new
    paths."""
    print('# Update sha ...')
    final = []
    for idx, path in enumerate(paths):
        print(f'{idx + 1:03d}: Processing {path}')
        net = torch.load(path, map_location='cpu', weights_only=True)
        basename = osp.basename(path)
        if 'params' not in net and 'params_ema' not in net:
            resp = input(f'WARN: Model {basename} does not have '
                         '"params"/"params_ema" key. Continue? Y/N\n')
            if resp.lower() == 'n':
                raise ValueError('Please modify..')
            if resp.lower() != 'y':
                raise ValueError('Wrong input. Only accepts Y/N.')

        new_sha = sha256_prefix(path)
        # the name is split, not the whole path (the JAX script splits the
        # path, so a '-' in a folder's name cut it short)
        stem = basename.split('-')[0] if '-' in basename \
            else basename.split('.pth')[0]
        final_file = osp.join(osp.dirname(path), f'{stem}-{new_sha}.pth')
        if final_file != path:
            print(f'\tSave from {path} to {final_file}')
            os.replace(path, final_file)
        final.append(final_file)
    return final


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('paths', nargs='*')
    args = parser.parse_args(argv)
    paths = args.paths or (
        glob.glob('experiments/pretrained_models/*.pth')
        + glob.glob('experiments/pretrained_models/**/*.pth'))
    return update_sha(paths)


if __name__ == '__main__':
    main()
