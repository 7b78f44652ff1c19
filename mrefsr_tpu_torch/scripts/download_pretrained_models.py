"""The reference's released ``.pth`` checkpoints from Google Drive (port of
``scripts/download_pretrained_models.py``)::

    python -m mrefsr_tpu_torch.scripts.download_pretrained_models ESRGAN
    python -m mrefsr_tpu_torch.scripts.download_pretrained_models all

Each goes to ``experiments/pretrained_models/<method>/``. A file already
there is covered only after a ``Y`` at the prompt. The port loads the
files as they are (``path.pretrain_network_g``).
"""
import argparse
import os
import os.path as osp

from mrefsr_tpu_torch.utils.download_util import \
    download_file_from_google_drive

# the file ids the reference publishes; an empty id has no public file
FILE_IDS = {
    'ESRGAN': {
        'ESRGAN_SRx4_DF2KOST_official-ff704c30.pth':
            '1b3_bWZTjNO3iL2js1yWkJfjZykcQgvzT',
        'ESRGAN_PSNR_SRx4_DF2K_official-150ff491.pth':
            '1swaV5iBMFfg-DL6ZyiARztbhutDCWXMM',
    },
    'EDVR': {},
    'StyleGAN': {},
    'EDSR': {},
    'DUF': {},
    'DFDNet': {},
    'TOF': {},
    'flownet': {
        'spynet_sintel_final-3d2a1287.pth': '',
    },
    'BasicVSR': {},
}


def confirm_cover(file_name):
    """Whether to cover ``file_name``, asked at the prompt: ``Y`` or ``N``
    (either case); any other answer raises."""
    resp = input(f'{file_name} already exists. Cover it? Y/N\n')
    if resp.lower() == 'n':
        return False
    if resp.lower() != 'y':
        raise ValueError('Wrong input. Only accepts Y/N.')
    return True


def download_pretrained_models(method, file_ids,
                               root='./experiments/pretrained_models'):
    save_path_root = osp.join(root, method)
    os.makedirs(save_path_root, exist_ok=True)
    for file_name, file_id in file_ids.items():
        if not file_id:
            print(f'No public file id recorded for {file_name}; '
                  'download it manually from the reference model zoo.')
            continue
        save_path = osp.abspath(osp.join(save_path_root, file_name))
        if osp.exists(save_path) and not confirm_cover(file_name):
            print(f'Skipping {file_name}')
            continue
        print(f'Downloading {file_name} to {save_path}')
        download_file_from_google_drive(file_id, save_path)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('method', type=str,
                        help="one of FILE_IDS keys, or 'all'")
    args = parser.parse_args(argv)
    methods = list(FILE_IDS) if args.method == 'all' else [args.method]
    for method in methods:
        download_pretrained_models(method, FILE_IDS[method])


if __name__ == '__main__':
    main()
