"""A packed shard (``.pack``, read by ``io_backend: {type: pack}``) from an
image folder (port of ``scripts/data_preparation/create_pack.py``)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.create_pack \\
        datasets/DIV2K/DIV2K_train_HR_sub datasets/DIV2K/train_HR_sub.pack

Each image is PNG-encoded under its path relative to the folder, without
the suffix; ``<pack>.meta_info.txt`` lists ``key.png (h,w,c) level``.
"""
import argparse
import os.path as osp

from mrefsr_tpu_torch.data.packio import PackWriter
from mrefsr_tpu_torch.utils.misc import scandir


def create_pack_from_folder(folder, pack_path, suffix='png', recursive=False,
                            compress_level=1):
    """Write ``pack_path`` from the ``suffix`` images of ``folder``, sorted
    by path; returns their count."""
    import cv2
    img_paths = sorted(scandir(folder, suffix=suffix, recursive=recursive))
    writer = PackWriter(pack_path)
    for idx, rel in enumerate(img_paths):
        img = cv2.imread(osp.join(folder, rel), cv2.IMREAD_UNCHANGED)
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        _, img_byte = cv2.imencode(
            '.png', img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
        writer.put(rel.split(f'.{suffix}')[0], img_byte.tobytes(),
                   shape=(h, w, c), compress_level=compress_level)
        if (idx + 1) % 500 == 0:
            print(f'{idx + 1}/{len(img_paths)}')
    writer.close()
    print(f'Wrote {len(img_paths)} images to {pack_path}')
    return len(img_paths)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('folder', type=str)
    parser.add_argument('pack_path', type=str,
                        help='output shard, e.g. data_train.pack')
    parser.add_argument('--suffix', type=str, default='png')
    parser.add_argument('--recursive', action='store_true')
    args = parser.parse_args(argv)
    return create_pack_from_folder(args.folder, args.pack_path,
                                   suffix=args.suffix,
                                   recursive=args.recursive)


if __name__ == '__main__':
    main()
