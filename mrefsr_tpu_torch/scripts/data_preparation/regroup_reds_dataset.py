"""REDS's validation clips copied into the training folder as clips 240 to
269 (port of ``scripts/data_preparation/regroup_reds_dataset.py``, the
reference's)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.regroup_reds_dataset \\
        [--train_path P --val_path Q]

Without paths it regroups ``datasets/REDS/train_sharp`` with
``val_sharp``, then ``train_sharp_bicubic/X4`` with ``val_sharp_bicubic/X4``.
"""
import argparse
import glob
import os
import shutil

REDS = (('datasets/REDS/train_sharp', 'datasets/REDS/val_sharp'),
        ('datasets/REDS/train_sharp_bicubic/X4',
         'datasets/REDS/val_sharp_bicubic/X4'))


def regroup_reds_dataset(train_path, val_path):
    """Copy each clip folder ``val_path/<n>`` to ``train_path/<n + 240>``."""
    for folder in glob.glob(os.path.join(val_path, '*')):
        new_folder_idx = int(os.path.basename(folder)) + 240
        shutil.copytree(folder,
                        os.path.join(train_path, str(new_folder_idx)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--train_path', type=str, default=None)
    parser.add_argument('--val_path', type=str, default=None)
    args = parser.parse_args(argv)
    pairs = REDS if args.train_path is None else (
        (args.train_path, args.val_path),)
    for train_path, val_path in pairs:
        regroup_reds_dataset(train_path, val_path)


if __name__ == '__main__':
    main()
