"""lmdb datasets of DIV2K, REDS and Vimeo-90K under ``datasets/`` (port of
``scripts/data_preparation/create_lmdb.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.create_lmdb \\
        --dataset div2k|reds|vimeo90k

Needs the ``lmdb`` module.
"""
import argparse
import os.path as osp

from mrefsr_tpu_torch.utils.lmdb_util import make_lmdb_from_imgs
from mrefsr_tpu_torch.utils.misc import scandir


def prepare_keys_div2k(folder_path):
    """The PNGs of ``folder_path`` (not recursive) and their keys."""
    print('Reading image path list ...')
    img_path_list = sorted(scandir(folder_path, suffix='png',
                                   recursive=False))
    return img_path_list, [p.split('.png')[0] for p in img_path_list]


def prepare_keys_reds(folder_path):
    """The PNGs under ``folder_path`` and their ``clip/frame`` keys."""
    print('Reading image path list ...')
    img_path_list = sorted(scandir(folder_path, suffix='png',
                                   recursive=True))
    return img_path_list, [p.split('.png')[0] for p in img_path_list]


def prepare_keys_vimeo90k(folder_path, train_list_path, mode):
    """The frames of the septuplets ``train_list_path`` lists (``im4`` alone
    for ``mode`` gt) and their ``folder/sub/imN`` keys (reference
    create_lmdb.py:123-160)."""
    print('Reading image path list ...')
    with open(train_list_path) as fin:
        train_list = [line.strip() for line in fin]
    img_path_list, keys = [], []
    for line in train_list:
        folder, sub_folder = line.split('/')
        frames = (['im4.png'] if mode == 'gt'
                  else [f'im{i}.png' for i in range(1, 8)])
        img_path_list.extend(osp.join(folder, sub_folder, f) for f in frames)
        keys.extend(f'{folder}/{sub_folder}/{f.split(".png")[0]}'
                    for f in frames)
    return img_path_list, keys


def create_lmdb_for_div2k():
    for folder_path, lmdb_path in (
            ('datasets/DIV2K/DIV2K_train_HR_sub',
             'datasets/DIV2K/DIV2K_train_HR_sub.lmdb'),
            ('datasets/DIV2K/DIV2K_train_LR_bicubic/X2_sub',
             'datasets/DIV2K/DIV2K_train_LR_bicubic_X2_sub.lmdb'),
            ('datasets/DIV2K/DIV2K_train_LR_bicubic/X3_sub',
             'datasets/DIV2K/DIV2K_train_LR_bicubic_X3_sub.lmdb'),
            ('datasets/DIV2K/DIV2K_train_LR_bicubic/X4_sub',
             'datasets/DIV2K/DIV2K_train_LR_bicubic_X4_sub.lmdb')):
        img_path_list, keys = prepare_keys_div2k(folder_path)
        make_lmdb_from_imgs(folder_path, lmdb_path, img_path_list, keys)


def create_lmdb_for_reds():
    for folder_path, lmdb_path in (
            ('datasets/REDS/train_sharp',
             'datasets/REDS/train_sharp_with_val.lmdb'),
            ('datasets/REDS/train_sharp_bicubic',
             'datasets/REDS/train_sharp_bicubic_with_val.lmdb')):
        img_path_list, keys = prepare_keys_reds(folder_path)
        make_lmdb_from_imgs(folder_path, lmdb_path, img_path_list, keys,
                            multiprocessing_read=True)


def create_lmdb_for_vimeo90k():
    train_list_path = 'datasets/vimeo90k/vimeo_septuplet/sep_trainlist.txt'
    for folder_path, lmdb_path, mode in (
            ('datasets/vimeo90k/vimeo_septuplet/sequences',
             'datasets/vimeo90k/vimeo90k_train_GT_only4th.lmdb', 'gt'),
            ('datasets/vimeo90k/vimeo_septuplet_matlabLRx4/sequences',
             'datasets/vimeo90k/vimeo90k_train_LR7frames.lmdb', 'lq')):
        img_path_list, keys = prepare_keys_vimeo90k(folder_path,
                                                    train_list_path, mode)
        make_lmdb_from_imgs(folder_path, lmdb_path, img_path_list, keys,
                            multiprocessing_read=True)


DATASETS = {'div2k': create_lmdb_for_div2k, 'reds': create_lmdb_for_reds,
            'vimeo90k': create_lmdb_for_vimeo90k}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset', type=str, required=True,
                        choices=sorted(DATASETS))
    DATASETS[parser.parse_args(argv).dataset]()


if __name__ == '__main__':
    main()
