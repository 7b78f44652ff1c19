"""Benchmark datasets from Google Drive (port of
``scripts/data_preparation/download_datasets.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.download_datasets Set5
    python -m mrefsr_tpu_torch.scripts.data_preparation.download_datasets all

Each archive goes to ``./datasets/``; one already there is covered only
after a ``Y`` at the prompt.
"""
import argparse
import os
import os.path as osp

from mrefsr_tpu_torch.scripts.download_pretrained_models import \
    confirm_cover
from mrefsr_tpu_torch.utils.download_util import \
    download_file_from_google_drive

FILE_IDS = {
    'Set5': {'Set5.zip': '1RtyIeUFTyW8u4zAEhmdQ3FWLv1Cy7EqA'},
    'Set14': {'Set14.zip': '1CzwwAtLSW9sog3acXj8s7Hg3S7kr2HiZ'},
}


def download_dataset(dataset, file_ids, save_path_root='./datasets/'):
    os.makedirs(save_path_root, exist_ok=True)
    for file_name, file_id in file_ids.items():
        save_path = osp.abspath(osp.join(save_path_root, file_name))
        if osp.exists(save_path) and not confirm_cover(file_name):
            print(f'Skipping {file_name}')
            continue
        print(f'Downloading {file_name} to {save_path}')
        download_file_from_google_drive(file_id, save_path)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('dataset', type=str,
                        help="one of FILE_IDS keys, or 'all'")
    args = parser.parse_args(argv)
    datasets = list(FILE_IDS) if args.dataset == 'all' else [args.dataset]
    for dataset in datasets:
        download_dataset(dataset, FILE_IDS[dataset])


if __name__ == '__main__':
    main()
