"""File downloads: Google Drive by file id, and a URL into a cache folder
(port of ``mrefsr_tpu/utils/download_util.py``, the reference's
``basicsr/utils/download_util.py:11-99``).

Both need network access and the ``requests`` package, which is imported
inside the functions that use it: importing this module costs nothing, and
a machine without ``requests`` gets an ``ImportError`` that names it."""
import math
import os
from urllib.parse import urlparse

from .misc import sizeof_fmt

GDRIVE_URL = 'https://docs.google.com/uc?export=download'


def _requests():
    try:
        import requests
    except ImportError as exc:
        raise ImportError('downloads need the requests package '
                          '(pip install requests)') from exc
    return requests


def download_file_from_google_drive(file_id, save_path):
    """Google Drive's file ``file_id`` to ``save_path``, past the
    confirmation page of a large file (reference download_util.py:11-45)."""
    session = _requests().Session()
    params = {'id': file_id}

    response = session.get(GDRIVE_URL, params=params, stream=True)
    token = get_confirm_token(response)
    if token:
        params['confirm'] = token
        response = session.get(GDRIVE_URL, params=params, stream=True)

    # the file's size, from a request of its first three bytes
    response_file_size = session.get(GDRIVE_URL, params=params, stream=True,
                                     headers={'Range': 'bytes=0-2'})
    if 'Content-Range' in response_file_size.headers:
        file_size = int(
            response_file_size.headers['Content-Range'].split('/')[1])
    else:
        file_size = None
    save_response_content(response, save_path, file_size)


def get_confirm_token(response):
    """The value of the ``download_warning*`` cookie, or None."""
    for key, value in response.cookies.items():
        if key.startswith('download_warning'):
            return value
    return None


def save_response_content(response, destination, file_size=None,
                          chunk_size=32768):
    """``response``'s body to ``destination`` in chunks, with a progress
    line when ``file_size`` is known. Progress counts the bytes received
    (the reference adds ``chunk_size`` for a short last chunk too, as the
    JAX package does not)."""
    downloaded_size = 0
    with open(destination, 'wb') as f:
        for chunk in response.iter_content(chunk_size):
            if not chunk:  # keep-alive chunks
                continue
            downloaded_size += len(chunk)
            if file_size is not None:
                ratio = math.ceil(downloaded_size / file_size * 100)
                print(f'\rDownload {ratio}% -- '
                      f'{sizeof_fmt(downloaded_size)} / '
                      f'{sizeof_fmt(file_size)}', end='')
            f.write(chunk)
        print()


def load_file_from_url(url, model_dir=None, progress=True, file_name=None):
    """The path of ``url``'s file in ``model_dir`` (default
    ``~/.cache/mrefsr_tpu_torch/weights``), downloaded first unless it is
    there (reference download_util.py:70-99). ``progress`` is kept for the
    reference's signature: a progress line shows whenever the server sends
    the size."""
    if model_dir is None:
        model_dir = os.path.join(os.path.expanduser('~'), '.cache',
                                 'mrefsr_tpu_torch', 'weights')
    os.makedirs(model_dir, exist_ok=True)

    filename = os.path.basename(urlparse(url).path)
    if file_name is not None:
        filename = file_name
    cached_file = os.path.abspath(os.path.join(model_dir, filename))
    if not os.path.exists(cached_file):
        print(f'Downloading: "{url}" to {cached_file}\n')
        with _requests().get(url, stream=True) as r:
            r.raise_for_status()
            save_response_content(
                r, cached_file,
                int(r.headers.get('Content-Length', 0)) or None)
    return cached_file
