"""A meta-info file of an image folder, one ``name (h,w,c)`` line an image
in sorted order (port of ``scripts/data_preparation/generate_meta_info.py``,
the reference's)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.generate_meta_info \\
        [--gt_folder datasets/DIV2K/DIV2K_train_HR_sub] \\
        [--meta_info_txt meta_info_DIV2K800sub_GT.txt]
"""
import argparse
import os.path as osp

from mrefsr_tpu_torch.utils.misc import scandir


def generate_meta_info_div2k(gt_folder='datasets/DIV2K/DIV2K_train_HR_sub',
                             meta_info_txt='meta_info_DIV2K800sub_GT.txt'):
    """Write ``meta_info_txt`` for ``gt_folder``: RGB images have 3
    channels, grey ones 1; any other mode raises."""
    from PIL import Image
    img_list = sorted(scandir(gt_folder))
    with open(meta_info_txt, 'w') as f:
        for idx, img_path in enumerate(img_list):
            with Image.open(osp.join(gt_folder, img_path)) as img:
                width, height = img.size
                mode = img.mode
            if mode == 'RGB':
                n_channel = 3
            elif mode == 'L':
                n_channel = 1
            else:
                raise ValueError(f'Unsupported mode {mode}.')
            info = f'{img_path} ({height},{width},{n_channel})'
            print(idx + 1, info)
            f.write(f'{info}\n')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--gt_folder', type=str,
                        default='datasets/DIV2K/DIV2K_train_HR_sub')
    parser.add_argument('--meta_info_txt', type=str,
                        default='meta_info_DIV2K800sub_GT.txt')
    args = parser.parse_args(argv)
    generate_meta_info_div2k(args.gt_folder, args.meta_info_txt)


if __name__ == '__main__':
    main()
