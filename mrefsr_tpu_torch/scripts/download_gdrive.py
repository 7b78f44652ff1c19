"""One file from Google Drive by its id (port of
``scripts/download_gdrive.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.download_gdrive --id <file id> \\
        --output <save path>
"""
import argparse

from mrefsr_tpu_torch.utils.download_util import \
    download_file_from_google_drive


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--id', type=str, help='File id')
    parser.add_argument('--output', type=str, help='Save path')
    args = parser.parse_args(argv)
    download_file_from_google_drive(args.id, args.output)


if __name__ == '__main__':
    main()
